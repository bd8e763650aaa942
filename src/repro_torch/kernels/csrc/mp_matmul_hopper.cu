// The limb matmuls' Hopper tiles (sm_90a), plain C interface: the fused
// matmul's two tiles, which replace _fused_kernel
// (src/repro/kernels/mp_matmul.py:76) beside fused_matmul_kernel of
// mp_matmul.cu; the fused projection's two tiles, which replace
// _fused_multi_kernel (:227) beside fused_proj_kernel; the decode tiles
// of the pre-limbed and mixed-lane matmuls, which replace _prelimbed_kernel
// (:108) and _mixed_prelimbed_kernel (:137) at M <= DEC_M; and the
// both-prelimbed matmul's tile, which replaces _both_prelimbed_kernel
// (:182) beside both_prelimbed_matmul_kernel.  Each keeps
// the order of sums of mp_matmul.cu bit for bit (its header: K in chunks
// of KC from k = 0, one chain of KC / 16 tensor-core k16 steps per chunk
// and kept product from +0.0, the order's terms summed by IEEE f32 adds in
// product order, acc[o] += tot, the compensated combine at the end),
// epilogues and lanes included.
//
// Which kernel runs which route (kernels/mp_matmul.py counts them):
//   the fused matmul and its partials: tma_matmul_kernel (tma, M > DEC_M,
//     operands a tensor map reads), matmul_split_kernel (cluster, M <=
//     DEC_M; at S = 1 fused_matmul_decode_kernel); mp_matmul.cu's
//     fused_matmul_kernel the rest (strided);
//   the projection: tma_matmul_kernel with the projection's epilogue (tma,
//     M > DEC_M, a and the weights' rows a multiple of 16 bytes, 16-byte
//     aligned), matmul_split_kernel<PROJ> (cluster, M <= DEC_M; at S = 1
//     fused_proj_decode_kernel); mp_matmul.cu's fused_proj_kernel the rest
//     (strided);
//   the pre-limbed and mixed-lane matmuls: matmul_split_kernel on stored
//     planes, the mixed one with each row's lane (cluster, M <= DEC_M; at
//     S = 1, or planes no map reads, prelimbed_matmul_decode_kernel and
//     mixed_prelimbed_matmul_decode_kernel); mp_matmul.cu's
//     prelimbed_matmul_kernel and mixed_prelimbed_matmul_kernel above
//     (mma);
//   the both-prelimbed matmul: both_tma_kernel (tma: a built-in format
//     whose stored planes a tensor map reads, any M); mp_matmul.cu's
//     both_prelimbed_matmul_kernel the rest (mma: the run-time formats,
//     rows or plane strides off 16 bytes, a misaligned base).
//
// tma_matmul_kernel, the prefill tile (M > DEC_M) of the operands a TMA
// tensor map can describe (unit column stride, 16-byte aligned bases and
// strides, up to two batch dims; mp_matmul.cu's tiles keep the others: a
// stride-0 broadcast, a transposed view read as it is).
//   Design: a 128 x BN tile per block (BN by format and weights, 96 at M8
//   and one weight, so that the 2048 x 768 outputs of wo and w_down make
//   128 tiles on 132 SMs; the blocks walk M first, so a weight larger than
//   L2 is read about once).  Limbing warpgroups (two at one limb, else
//   one), whose first thread is the TMA producer (cp.async.bulk.tensor of
//   A's and each weight's box into a ring of RS f32 stages, each stage
//   completing an mbarrier; TMA zero-fills past M, N and K, which is the
//   contract's zero-filled chunk edge), turn each stage into its bf16 limb
//   planes in the 128-byte swizzle wgmma reads (A K-major, once for all
//   the block's weights; B N-major as it lies, with the transpose bit,
//   from 64 columns, else transposed to K-major on the way), into one of
//   NPB plane buffers.  Two consumer warpgroups of 64 rows each chain four
//   wgmma m64nBNk16 into a fresh accumulator (zeroed, scale-d 1: the +0.0
//   start of mma_bf16_first), then wgmma.wait_group and the CUDA-core
//   adds; one warpgroup's adds overlap the other's chains, and named
//   barriers hand the plane buffers over.  Four wgmma k16 steps give four
//   mma.sync m16n8k16 steps' bits (compare_kernels.py's cases, signs of
//   zero and subnormal products included), so every bitwise gate of the
//   old tiles holds.  Registers set BN: NOUT x NO accumulators, the
//   order's running sum and one chain per output within the registers of
//   the block's threads.  The epilogue (template Epi) stores the combined
//   sum, the per-order sums (PARTS) or the projection's proj_store (bias,
//   silu(g) * u, residual: the same code as fused_proj_kernel's).
//   The projection (launch_tma_proj): gated, both weights in a block
//   (NOUT = 2: g and u of one output in one thread; 64 columns at M8);
//   QKV's three weights in one block where the tile keeps 24 columns (M8
//   48, M16 24), else the grid walks the weights, one a block: on the
//   H100, QKV 2048 x 768 M8 0.0572 ms against fused_proj_kernel's
//   mma.sync tile's 0.0974 and one block per weight's 0.0618, SwiGLU
//   0.1402 against 0.1961 (PERF.md).
//   Bound now: the f32 operands cross from L2 once per tile, each A row
//   block once per column block and each B column block once per row
//   block (352 MB at w_down, 2048 x 3072 x 768 M8; about 600 MB at the
//   SwiGLU prefill; 4.7 GB at lm_head M16, whose BN of 64 the three live
//   chains per output cap); neither the limbing nor the MMAs, nor deeper
//   stages, move its time much.  A cluster of two column tiles sharing A
//   by TMA multicast measured slower on the H100 and is not kept.  M16's
//   tile (168 registers, 20-36 bytes of spill) is no faster than the
//   mma.sync tile at the training step's gate / up (0.1713 against 0.1648
//   ms) and is faster at its QKV (0.0692 against 0.0805).
//   Registers: one block an SM of 384 threads (one limbing warpgroup,
//   from two limbs) leaves 168 a thread; from three limbs setmaxnreg
//   moves the limbers' registers to the consumers (56 and 224 a thread),
//   which removed ptxas's spills (100 bytes at M23); M16 keeps 168 and
//   spills 20 bytes, where moving them measured slower.
//   Its partials epilogue (PARTS) takes one limb only: at more, the
//   strided tile of mp_matmul.cu measured faster on the K-sharded
//   lm_head at M16 and keeps that route (PERF.md).
//
// matmul_split_kernel, the decode tile (M <= DEC_M) of the fused matmul
// (its f32 weight), of the projection (PROJ: NOUT f32 weights a block) and
// of the pre-limbed and mixed-lane matmuls (PL: the stored planes; LN: each
// row at its lane).
//   Bound: the bytes of the weight, streamed by too few blocks: one block
//   per 16 columns makes 48 blocks at N = 768.
//   Design: a thread-block cluster of S blocks (S <= 8) shares one 16-column
//   slab; rank r runs a contiguous range of K's chunks through
//   mp_matmul_common.cuh's decode_tile and keeps each chunk's per-order sum
//   tot_c in its shared memory; after cluster.sync() each rank takes 1/S
//   of the slab's outputs and forms acc[o] = ((+0.0 + tot_0) + tot_1) +
//   ... in chunk order, reading the other ranks' sums through distributed
//   shared memory, then combines and stores; a last cluster.sync() keeps
//   every rank's shared memory alive until the others have read it.
//   These are the single block's adds in the single block's order (acc
//   never holds -0.0, so a chunk sum kept as +0.0 + tot_c adds the same as
//   tot_c).  The f32 weight comes through decode_tile's cp.async ring and
//   limbing warps; the stored planes by TMA (one 16-column box of the
//   rank's stage of k per plane, the 32-byte swizzle laying the rows as
//   dec_col does, completing a ring slot's mbarrier), so its producer
//   warps only copy A: 7% faster than their cp.async copies at w_down
//   (0.0153 against 0.0165 ms, PERF.md).  The plan (split_plan) takes the
//   largest S whose blocks all fit on the card at once: on the f32 weight
//   S = 8 at w_down M8 (384 blocks of 6 chunks, 128 k a stage), 6 at wo;
//   on stored planes (their bf16 ring, 8 blocks an SM) S = 8 at w_down
//   (256 k a stage), 6 at wo, 4 at w_up; 1 at lm_head (2,000 slabs),
//   where the kernels are the old decode tiles as they were
//   (fused_matmul_decode_kernel, prelimbed_matmul_decode_kernel).
//   The projection (PROJ): each rank's chunk sums of its NOUT weights, the
//   join forms each weight's sum, combines it and runs proj_store once per
//   output (bias, silu(g) * u, residual, as every projection tile); gated,
//   both weights a block, else one a block with grid.y walking QKV's
//   (faster than the three in one cluster, A limbed once: 0.0097 against
//   0.0116 ms).  On f32 weights the plan also asks a rank for fewer stages
//   than the single block runs: halving a stage to fit more blocks keeps
//   their count and only adds the join, so the gated projection at M8
//   (two f32 rings a block) keeps S = 1, as every (dk, S) swept there was
//   slower (PERF.md).  The mixed-lane matmul (LN): each row keeps its lane
//   in registers, chunk_step adds only its kept terms (a chunk sum of an
//   order above its cut stays +0.0), and the join combines each row from
//   its own cut down (lane_ord, read from global memory); its planes come
//   by TMA as the pre-limbed matmul's, and it keeps its single-block tile
//   with its own MixedPrelimbedArgs at S = 1 (lm_head).  The plan reads each
//   split kernel's registers (cudaFuncGetAttributes): above 64 a thread
//   fewer blocks share an SM (the projection's 78 at M8, 88 gated).
//   Bound now: each rank runs one or two short stages, so the ring's
//   fill, the launch of a cluster and the chunk sums' join through
//   distributed shared memory, not the weight's bytes, set its time:
//   pre-limbed w_down 0.0153 ms against 0.0014 of bytes, mixed w_down
//   0.0321 against 0.0043, QKV M8 0.0098 against 0.0021; the f32 weight's
//   B stream is still cp.async.
//
// both_tma_kernel, the both-prelimbed matmul (two-float operands at M36
// and M52: 15 and 28 products a chunk) on stored planes.
//   Bound: its limb products at the tensor cores' rate (2.85 ms at lm_head
//   2048 x 768 x 32000 M52), and the planes' trips from L2: each A plane
//   block crosses once per column tile, each B plane block once per row
//   tile.  Registers set the tile: each output carries one accumulator per
//   order it holds, the order's running sum and a chain.
//   Design: no f32 stage and no limbing.  The producer warpgroup's first
//   thread keeps TMA loads of the stored planes in flight (A K-major in
//   boxes of 64 k x the tile's rows, B N-major in boxes of 64 columns x 64
//   k, both in the 128-byte swizzle wgmma reads, with the transpose bit for
//   B) through a ring of full and empty mbarriers; TMA zero-fills past M,
//   N and K, the contract's zero-filled chunk edge; planes past a stack's
//   stored count are zeroed once and their products run.  Two consumer
//   warpgroups run one chain of four wgmma k16 steps per kept product, the
//   first at scale-d 0 (d = A @ B: no zeroing, which ran lm_head M52 at
//   6.86 ms against 4.81), wgmma.wait_group, then the CUDA-core adds; one
//   warpgroup's adds overlap the other's chains.  A chain gives the
//   mma.sync chain's bits but for the sign of a zero sum, which no later
//   add keeps.  Every thread has the 168 registers of 384 (ptxas gave the
//   consumers no more under setmaxnreg), so the accumulators a thread
//   holds set the tile.  The order split (M36, M52): both warpgroups on the
//   same 64 rows (M36 64 columns, M52 48), each with a fixed subset of the
//   orders balanced by products (M52 {0, 1, 2, 6} and {3, 4, 5}, M36 {0,
//   1, 4} and {2, 3}), so a thread holds four orders, not seven; after the
//   last stage warpgroup 1 hands its sums to warpgroup 0 through the ring,
//   which combines from the highest order down.  The row split (each
//   warpgroup 64 rows, every order; M8 128 x 128, M16 and M23 x 64) is the
//   formats' with too few orders to split; a row split at M52 (128 x 48,
//   measured on a source variant) took 1.7x the order split's time at
//   lm_head and is not kept.  Each format has one tile.  The blocks walk
//   M first, so B's planes (344 MB at lm_head M52) are read from device
//   memory about once.
//   Bound now: 59% of the MMA bound at lm_head M52 (4.79 ms against 2.85),
//   faster than 28 bf16 torch.mm products (5.51).  Not by L2 alone: a
//   cluster pair sharing A's planes by TMA multicast, half of A's trips,
//   ran slower (5.92 ms) and is not kept; each warpgroup still waits for
//   every chain before its adds (two chain buffers, tried at 256 threads,
//   spilled and ran slower), and wgmma n48 reads both operands from shared
//   memory.
//
// Launch parameters the order leaves free, which the autotuner may set per
// launch (mp_hopper_matmul_launch's p0, p1; 0 keeps the plan): the decode
// tile's k per ring stage and cluster size.  The prefill tile and the
// both-prelimbed tile have none.
//
// The tensor maps come from cuTensorMapEncodeTiled, a driver-API function,
// obtained through the runtime's cudaGetDriverEntryPointByVersion (no
// -lcuda).  Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// --fmad=false (no --use_fast_math), as mp_matmul.cu.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include <cstring>
#include <type_traits>

#include "mp_matmul_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// wgmma m64nNk16, bf16 x bf16 -> f32, both operands in shared memory in the
// 128-byte swizzle: A K-major, B K-major (TB 0) or N-major (TB 1, the
// transpose bit); d += A @ B (scale-d sd = 1) or d = A @ B (sd = 0)
template <int N, int TB>
struct Wg;
template <>
struct Wg<8, 0> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t da,
                                             uint64_t db, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(sd));
  }
};
template <>
struct Wg<24, 0> {
  static __device__ __forceinline__ void run(float (&d)[12], uint64_t da,
                                             uint64_t db, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "%12, %13, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(sd));
  }
};
template <>
struct Wg<32, 0> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                             uint64_t db, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(sd));
  }
};
template <>
struct Wg<48, 0> {
  static __device__ __forceinline__ void run(float (&d)[24], uint64_t da,
                                             uint64_t db, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(sd));
  }
};
template <>
struct Wg<64, 1> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(sd));
  }
};
template <>
struct Wg<96, 1> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t da,
                                             uint64_t db, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(sd));
  }
};
template <>
struct Wg<48, 1> {
  static __device__ __forceinline__ void run(float (&d)[24], uint64_t da,
                                             uint64_t db, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(sd));
  }
};
template <>
struct Wg<128, 1> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(sd));
  }
};
template <int N, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int sd = 1) {
  Wg<N, TB>::run(d, da, db, sd);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// matrix descriptors of bf16 tiles in the 128-byte swizzle, from 1024-byte
// aligned bases.  K-major: rows of 64 k (128 bytes), 8-row groups 1024
// bytes apart; the k16 step ks starts 32 bytes further (+2 in the address
// field).  N-major: rows of 64 n, one per k, 8-k groups 1024 bytes apart,
// 64-column atoms 8 KB apart; the k16 step starts 2048 bytes further.
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}
__device__ __forceinline__ uint64_t desc_n(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t)(8192 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// element offset of (row, 4 k at k = 4 kq) in a K-major tile
__device__ __forceinline__ int swz(int row, int kq) {
  return row * KC + ((((kq >> 1) ^ (row & 7)) << 3) | ((kq & 1) << 2));
}

// element offset of (k, 4 columns at n) in an N-major tile
__device__ __forceinline__ int swz_n(int k, int n) {
  return (n >> 6) * (64 * KC) + k * 64 + ((((n & 63) >> 3) ^ (k & 7)) << 3) +
         (n & 7);
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// The prefill tile.

constexpr int HM = 128;                // rows of a tile: two warpgroups of 64
constexpr int HP = 2 * 128;            // the first limbing thread
constexpr int HALIGN = 1024;           // the swizzle's alignment
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_LIMB = 5;  // named barriers

// the tile's columns by format and weights per block: NOUT x NO
// accumulators, the order's sum and one chain of BN / 2 registers each per
// thread within the registers of the block's threads (no = NOUT x NO)
__host__ __device__ constexpr int hp_bn(int no) {
  return no == 1 ? 96 : no == 2 ? 64 : no == 3 ? 48 : no <= 5 ? 32
       : no <= 7 ? 24 : 8;
}
// B's planes N-major (limbed from the f32 stage as it lies) where the tile
// has 64 columns or more, else K-major (transposed while limbing)
__host__ __device__ constexpr bool hp_nmaj(int bn) { return bn >= 64; }
__host__ __device__ constexpr int64_t hp_plane_b(int bn) {
  return hp_nmaj(bn) ? (int64_t)(bn + 63) / 64 * 64 * KC * 2
                     : (int64_t)bn * KC * 2;
}
// limbing warpgroups: two where the consumers' registers fit 512 threads
// (one limb), else one
__host__ __device__ constexpr int hp_lwg(int nl) { return nl == 1 ? 2 : 1; }
// bytes of one plane buffer (NL A planes of HM x KC, NL B planes per
// weight, bf16) and of one f32 stage (A's HM x KC, each weight's KC x BN)
__host__ __device__ constexpr int64_t hp_planes(int nl, int bn, int nout) {
  return (int64_t)nl * ((int64_t)HM * KC * 2 + nout * hp_plane_b(bn));
}
__host__ __device__ constexpr int64_t hp_stage(int bn, int nout) {
  return (int64_t)(HM + nout * bn) * KC * 4;
}
// plane buffers: two where two and two stages fit, else one
__host__ __device__ constexpr int hp_npb(int nl, int bn, int nout) {
  return HALIGN + 2 * hp_planes(nl, bn, nout) + 2 * hp_stage(bn, nout) + 64 <=
                 SMEM_MAX
             ? 2 : 1;
}
__host__ __device__ constexpr int64_t hp_smem(int nl, int bn, int rs,
                                              int nout) {
  return HALIGN + hp_npb(nl, bn, nout) * hp_planes(nl, bn, nout) +
         rs * hp_stage(bn, nout) + 8 * 4;
}
// f32 stages: three where they fit, else two (deeper rings did not move
// the tile's time on the H100)
__host__ __device__ constexpr int hp_rs(int nl, int bn, int nout) {
  return hp_smem(nl, bn, 3, nout) <= SMEM_MAX ? 3 : 2;
}

// NOUT weights per block: the fused matmul's one; the projection's one
// (the grid walks its weights) or, gated, both (silu(g) * u needs g and
// u of one output in one thread)
template <int NL, int NO, int NOUT = 1>
struct Hp {
  static constexpr int BN = hp_bn(NOUT * NO);
  static constexpr int R = BN / 2;     // accumulator registers per chain
  static constexpr bool NMAJ = hp_nmaj(BN);
  static constexpr int LT = 128 * hp_lwg(NL);   // limbing threads
  static constexpr int HT = HP + LT;            // threads
  // from three limbs (one limbing warpgroup: 384 threads, 168 registers a
  // thread at one block an SM) the limbers hand registers to the
  // consumers' chains, 2 x 128 x CREG + 128 x LREG = 384 x 168: no spill,
  // 7-24% faster at M23-M52 on the H100; at M16 it measured 1% slower, so
  // M16 keeps 168 and a 20-byte spill (PERF.md)
  static constexpr bool MOVE_REGS = NL >= 3;
  static constexpr int LREG = 56, CREG = 224;
  static constexpr int NPB = hp_npb(NL, BN, NOUT);
  static constexpr int RS = hp_rs(NL, BN, NOUT);
  static constexpr int64_t PA = (int64_t)HM * KC * 2;   // one A plane
  static constexpr int64_t PB = hp_plane_b(BN);         // one B plane
  static constexpr int64_t SMEM = hp_smem(NL, BN, RS, NOUT);
  static_assert(SMEM <= SMEM_MAX, "the f32 stages fit");
  static_assert(PB % HALIGN == 0, "B planes keep the swizzle's alignment");
  static_assert((LT / 16) % 8 == 0 && HM * KC / 4 % LT == 0,
                "a limber's A chunks share one swizzle phase");
};

// one chain: d = +0.0, then KC / 16 wgmma steps of A's limb plane (the
// warpgroup's 64 rows) against B's
template <int R, bool NMAJ>
__device__ __forceinline__ void chain(float (&d)[R], uint64_t da,
                                      uint64_t db) {
#pragma unroll
  for (int e = 0; e < R; ++e) d[e] = 0.f;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma<2 * R, NMAJ ? 1 : 0>(d, da + 2 * ks, db + (NMAJ ? 128 : 2) * ks);
  wg_commit();
}

// the same chain with its first k16 step at scale-d 0 (d = A @ B): no
// zeroing.  A chain's sum differs from the zeroed one's only where it is a
// zero, whose sign no later add keeps (an order's accumulator starts at
// +0.0 and +0.0 + -0.0 is +0.0, so it never holds -0.0)
template <int R>
__device__ __forceinline__ void chain_n(float (&d)[R], uint64_t da,
                                        uint64_t db) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma<2 * R, 1>(d, da + 2 * ks, db + 128 * ks, ks > 0);
  wg_commit();
}

// what a block of the prefill tile stores: the combined sum (the fused
// matmul), the per-order sums (its partials epilogue), or the projection's
// epilogue (proj_store)
enum class Epi { COMBINE, PARTS, PROJ };

// the tile's tensor maps: A's, and each weight's (the fused matmul has one)
struct TmaMaps {
  CUtensorMap a;
  CUtensorMap b[MAX_OUT];
};

// where the tile stores: the fused matmul's C (strides in elements, batch
// z = z0 * nb1 + z1; PARTS: order o's plane at C + o * c_so) or the
// projection's ProjArgs (PROJ; weights t0 = blockIdx.y * NOUT onwards)
struct TmaArgs {
  float* C;
  int64_t c_sb0, c_sb1, c_sr, c_sc, c_so;
  int nb1, M, N, K, n_limbs, max_order;
  ProjArgs proj;
};

template <int NL, int NO, int NOUT, bool GEN, Epi EPI>
__global__ void __launch_bounds__(Hp<NL, NO, NOUT>::HT, 1) tma_matmul_kernel(
    const __grid_constant__ TmaMaps maps, const TmaArgs t) {
  using H = Hp<NL, NO, NOUT>;
  constexpr int BN = H::BN, R = H::R, NPB = H::NPB, RS = H::RS, LT = H::LT,
                HT = H::HT;
  extern __shared__ unsigned char hp_raw[];
  unsigned char* const sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(hp_raw) + HALIGN - 1) &
      ~(uintptr_t)(HALIGN - 1));
  constexpr int64_t PLANES = hp_planes(NL, BN, NOUT);
  constexpr int64_t STAGE = hp_stage(BN, NOUT);
  auto plane_a = [&](int p, int i) {
    return reinterpret_cast<__nv_bfloat16*>(sm + p * PLANES + i * H::PA);
  };
  auto plane_b = [&](int p, int w, int j) {   // weight w's limb j
    return reinterpret_cast<__nv_bfloat16*>(sm + p * PLANES + NL * H::PA +
                                            (w * NL + j) * H::PB);
  };
  auto stage_a = [&](int r) {
    return reinterpret_cast<float*>(sm + NPB * PLANES + r * STAGE);
  };
  auto stage_b = [&](int r, int w) {
    return reinterpret_cast<float*>(sm + NPB * PLANES + r * STAGE +
                                    ((int64_t)HM + w * BN) * KC * 4);
  };
  uint64_t* const full =   // full[r]: stage r has landed (TMA's bytes)
      reinterpret_cast<uint64_t*>(sm + NPB * PLANES + RS * STAGE);

  const int M = t.M, N = t.N, K = t.K;
  const int nl = GEN ? t.n_limbs : NL;
  const int mo = GEN ? t.max_order : NO - 1;
  const int mt = (M + HM - 1) / HM;
  const int m0 = (int)(blockIdx.x % mt) * HM;   // M first (mp_matmul.cu)
  const int n0 = (int)(blockIdx.x / mt) * BN;
  // the block's first weight (the fused matmul has one)
  const int t0 = EPI == Epi::PROJ ? (int)blockIdx.y * NOUT : 0;
  const int z0 = (int)blockIdx.z / t.nb1, z1 = (int)blockIdx.z % t.nb1;
  const int stages = (K + KC - 1) / KC;
  const int tid = threadIdx.x;

  if (tid == HP) {
    for (int r = 0; r < RS; ++r) mbar_init(full + r);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= HP) {
    // the limbing warpgroups; the first thread keeps the TMA loads in flight
    if constexpr (H::MOVE_REGS)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(H::LREG));
    const int lt = tid - HP;
    auto issue = [&](int s, int r) {   // stage s into slot r
      mbar_expect(full + r, (int)STAGE);
      tma_load(stage_a(r), &maps.a, s * KC, m0, z1, z0, full + r);
#pragma unroll
      for (int w = 0; w < NOUT; ++w)
        tma_load(stage_b(r, w), &maps.b[t0 + w], n0, s * KC, z1, z0,
                 full + r);
    };
    if (lt == 0)
      for (int s = 0; s < RS && s < stages; ++s) issue(s, s);
    // A: 4 k of a row per chunk, 16 chunks a row; this thread's chunks are
    // column 4 kq of rows r0, r0 + LT / 16, ..., all in one swizzle phase
    const int kq = lt & 15, r0 = lt >> 4;
    const int a_src = r0 * KC + 4 * kq, a_dst = swz(r0, kq);
    constexpr int A_STEP = LT / 16 * KC;
#pragma unroll 1
    for (int s = 0; s < stages; ++s) {
      const int r = s % RS, p = s % NPB;
      mbar_wait(full + r, (s / RS) & 1);
      if (s >= NPB) bar_sync(BAR_EMPTY + p, HT);  // the consumers are done
      const float* const fa = stage_a(r);
#pragma unroll
      for (int i = 0; i < HM * KC / 4 / LT; ++i)
        limb4v<NL>(*reinterpret_cast<const float4*>(fa + a_src + i * A_STEP),
                   plane_a(p, 0) + a_dst + i * A_STEP, H::PA / 2, nl);
#pragma unroll
      for (int w = 0; w < NOUT; ++w) {
        const float* const fb = stage_b(r, w);
        if constexpr (H::NMAJ) {
          // B as it lies: 4 columns of one k per chunk
#pragma unroll 4
          for (int it = lt; it < BN * KC / 4; it += LT) {
            const int k = it / (BN / 4), n = 4 * (it % (BN / 4));
            limb4v<NL>(*reinterpret_cast<const float4*>(fb + k * BN + n),
                       plane_b(p, w, 0) + swz_n(k, n), H::PB / 2, nl);
          }
        } else {
          // B transposed: 4 k of one column per chunk
#pragma unroll 4
          for (int it = lt; it < BN * KC / 4; it += LT) {
            const int n = it % BN, k4 = it / BN;
            const float4 x = make_float4(
                fb[(4 * k4) * BN + n], fb[(4 * k4 + 1) * BN + n],
                fb[(4 * k4 + 2) * BN + n], fb[(4 * k4 + 3) * BN + n]);
            limb4v<NL>(x, plane_b(p, w, 0) + swz(n, k4), H::PB / 2, nl);
          }
        }
      }
      // the planes are read by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(BAR_FULL + p, HT);
      if (s + RS < stages) {
        bar_sync(BAR_LIMB, LT);   // every limber is done with slot r
        if (lt == 0) issue(s + RS, r);
      }
    }
  } else {
    // the consumer warpgroups: rows 64 w .. 64 w + 63 of the tile
    if constexpr (H::MOVE_REGS)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(H::CREG));
    const int wg = tid >> 7;
    float acc[NOUT][NO][R];
#pragma unroll
    for (int w = 0; w < NOUT; ++w)
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int e = 0; e < R; ++e) acc[w][o][e] = 0.f;
#pragma unroll 1
    for (int s = 0; s < stages; ++s) {
      const int p = s % NPB;
      bar_sync(BAR_FULL + p, HT);
      auto da = [&](int i) { return desc_k(plane_a(p, i) + 64 * wg * KC); };
      auto db = [&](int w, int j) {
        return H::NMAJ ? desc_n(plane_b(p, w, j)) : desc_k(plane_b(p, w, j));
      };
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        if (o > mo) continue;
        const int i0 = o - nl + 1 > 0 ? o - nl + 1 : 0;
        const int i1 = o < nl - 1 ? o : nl - 1;
#pragma unroll
        for (int w = 0; w < NOUT; ++w) {
          // the order's first kept product, then the others in turn; each
          // weight's sums its own
          float tot[R];
          chain<R, H::NMAJ>(tot, da(i0), db(w, o - i0));
          wg_wait<0>();
#pragma unroll 1
          for (int i = i0 + 1; i <= i1; ++i) {
            float f[R];
            chain<R, H::NMAJ>(f, da(i), db(w, o - i));
            wg_wait<0>();
#pragma unroll
            for (int e = 0; e < R; ++e) tot[e] = tot[e] + f[e];
          }
#pragma unroll
          for (int e = 0; e < R; ++e) acc[w][o][e] = acc[w][o][e] + tot[e];
        }
      }
      if (s + NPB < stages) bar_arrive(BAR_EMPTY + p, HT);
    }

    // accumulator e of the warpgroup's m64nBN fragment: row 16 warp + lane / 4
    // + 8 ((e / 2) % 2), column 8 (e / 4) + 2 (lane % 4) + e % 2
    const int lane = tid & 31, wi = (tid >> 5) & 3;
    float* const Cz = t.C + z0 * t.c_sb0 + z1 * t.c_sb1;
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int64_t gm =
          m0 + 64 * wg + 16 * wi + (lane >> 2) + 8 * ((e >> 1) & 1);
      const int64_t gn = n0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      if (gm >= M || gn >= N) continue;
      if constexpr (EPI == Epi::PARTS) {
#pragma unroll
        for (int o = 0; o < NO; ++o)
          if (o <= mo) Cz[o * t.c_so + gm * t.c_sr + gn * t.c_sc] = acc[0][o][e];
      } else {
        float y[NOUT];
#pragma unroll
        for (int w = 0; w < NOUT; ++w) {
          float per_order[NO];
#pragma unroll
          for (int o = 0; o < NO; ++o) per_order[o] = acc[w][o][e];
          y[w] = combine_orders<NO>(per_order, mo);
        }
        if constexpr (EPI == Epi::PROJ)
          proj_store<NOUT>(t.proj, gm, gn, t0, y);
        else
          Cz[gm * t.c_sr + gn * t.c_sc] = y[0];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The both-prelimbed tile: both operands as stored bf16 planes, fed by TMA
// straight into the buffers wgmma reads (no f32 stage, no limbing).

// two consumer warpgroups and the producer's: every thread has the 168
// registers of 384 (ptxas allocated no more to the consumers under
// setmaxnreg, PERF.md), so the accumulators a thread holds set the tile
constexpr int BP_CT = 256;            // consumer threads: two warpgroups
constexpr int BP_T = BP_CT + 128;     // and the producer's warpgroup
constexpr int BAR_BP_DONE = 1, BAR_BP_X = 2;   // named barriers

// the order split: warpgroup 1 takes the orders lo..hi, warpgroup 0 the
// rest, balanced by products (M52's 28 as {0, 1, 2, 6} = 13 and {3, 4, 5} =
// 15; M36's 15 as {0, 1, 4} = 8 and {2, 3} = 7)
__host__ __device__ constexpr int bp_lo(int no) { return no == 7 ? 3 : 2; }
__host__ __device__ constexpr int bp_hi(int no) { return no == 7 ? 5 : 3; }
// warpgroup w's q-th order, -1 past its last
__host__ __device__ constexpr int bp_order(int no, int w, int q) {
  return w == 1 ? (bp_lo(no) + q <= bp_hi(no) ? bp_lo(no) + q : -1)
       : q < bp_lo(no) ? q
       : bp_hi(no) + 1 + q - bp_lo(no) < no ? bp_hi(no) + 1 + q - bp_lo(no)
                                             : -1;
}
__host__ __device__ constexpr int bp_count(int no, int w) {
  return w == 1 ? bp_hi(no) - bp_lo(no) + 1 : no - (bp_hi(no) - bp_lo(no) + 1);
}
// each format's one split: the order split where five or seven orders
// fill two warpgroups (M36, M52), else the row split (each warpgroup 64
// rows and every order, the prefill tile's split)
__host__ __device__ constexpr bool bp_osplit(int no) {
  return no == 5 || no == 7;
}
__host__ __device__ constexpr int bp_bm(int no) {
  return bp_osplit(no) ? 64 : 128;
}
// the tile's columns.  The row split: the format's NO accumulators, the
// order's sum and one chain of BN / 2 registers a thread within 168.  The
// order split: M36's warpgroup 0 holds three orders (64 columns), M52's
// four (48; at 64 ptxas spills 276 bytes and lm_head took 5.14 ms against
// 4.82, at 56 5.81, PERF.md)
__host__ __device__ constexpr int bp_bn(int no) {
  return no == 7 ? 48 : no == 1 ? 128 : 64;
}
// one stage: NL A planes of BM x KC (K-major) and NL B planes of KC x BN,
// N-major in 64-column boxes (bf16)
__host__ __device__ constexpr int64_t bp_stage(int nl, int no) {
  return (int64_t)nl * ((int64_t)bp_bm(no) * KC * 2 +
                        (int64_t)(bp_bn(no) + 63) / 64 * 64 * KC * 2);
}
// stages of the ring: as many as fit, at most four
__host__ __device__ constexpr int bp_stages(int nl, int no) {
  return (SMEM_MAX - HALIGN - 64) / bp_stage(nl, no) < 4
             ? (int)((SMEM_MAX - HALIGN - 64) / bp_stage(nl, no))
             : 4;
}
__host__ __device__ constexpr int64_t bp_smem(int nl, int no) {
  return HALIGN + bp_stages(nl, no) * bp_stage(nl, no) + 64;
}

template <int NL, int NO>
struct Bt {
  static constexpr bool OS = bp_osplit(NO);
  static constexpr int BM = bp_bm(NO), BN = bp_bn(NO);
  static constexpr int R = BN / 2;       // accumulator registers per chain
  static constexpr int ATOMS = (BN + 63) / 64;   // B's 64-column boxes
  // accumulators a thread: its warpgroup's orders
  static constexpr int NACC = OS ? (bp_count(NO, 0) > bp_count(NO, 1)
                                        ? bp_count(NO, 0)
                                        : bp_count(NO, 1))
                                 : NO;
  static constexpr int64_t PA = (int64_t)BM * KC * 2;    // one A plane
  static constexpr int64_t PB = (int64_t)ATOMS * 64 * KC * 2;   // one B plane
  static constexpr int64_t STAGE = bp_stage(NL, NO);
  static constexpr int ST = bp_stages(NL, NO);
  static constexpr int64_t SMEM = bp_smem(NL, NO);
  static_assert(ST >= 1 && SMEM <= SMEM_MAX, "one stage fits");
  static_assert(!OS || (int64_t)bp_count(NO, 1) * R * BP_CT / 2 * 4 <=
                           ST * STAGE,
                "warpgroup 1's sums fit the ring");
};

struct BothMaps {
  CUtensorMap a;   // (K, M, A's planes), boxes of KC x BM
  CUtensorMap b;   // (N, K, B's planes), boxes of 64 x KC
};

struct BothArgs {
  float* C;
  int64_t c_sr;
  int M, N, K, nsa, nsb;   // nsa, nsb: the planes each map holds
};

// One consumer warpgroup's K loop: for each stage (a ring slot), each of
// its orders q (warpgroup W's under the order split, every order under the
// row split) and each kept product of the order in the format's product
// order, one chain of KS wgmma k16 steps from +0.0; the order's terms
// summed by f32 adds, then acc[q] += tot; then the slot is released.
// a_row: the byte offset of the warpgroup's 64 rows in an A plane.
template <int NL, int NO, int W>
__device__ __forceinline__ void bp_consume(
    const unsigned char* ring, uint64_t* full, uint64_t* empty, int stages,
    int a_row, float (&acc)[Bt<NL, NO>::NACC][Bt<NL, NO>::R]) {
  using T = Bt<NL, NO>;
  constexpr int R = T::R, ST = T::ST;
#pragma unroll
  for (int q = 0; q < T::NACC; ++q)
#pragma unroll
    for (int e = 0; e < R; ++e) acc[q][e] = 0.f;
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    const int slot = s % ST;
    mbar_wait(full + slot, (s / ST) & 1);
    const unsigned char* const st = ring + slot * T::STAGE;
    auto da = [&](int i) { return desc_k(st + i * T::PA + a_row); };
    auto db = [&](int j) { return desc_n(st + NL * T::PA + j * T::PB); };
#pragma unroll
    for (int q = 0; q < T::NACC; ++q) {
      const int o = T::OS ? bp_order(NO, W, q) : q;
      if (o < 0) continue;
      const int i0 = o - NL + 1 > 0 ? o - NL + 1 : 0;
      const int i1 = o < NL - 1 ? o : NL - 1;
      float tot[R];
      chain_n<R>(tot, da(i0), db(o - i0));
      wg_wait<0>();
#pragma unroll 1
      for (int i = i0 + 1; i <= i1; ++i) {
        float f[R];
        chain_n<R>(f, da(i), db(o - i));
        wg_wait<0>();
#pragma unroll
        for (int e = 0; e < R; ++e) tot[e] = tot[e] + f[e];
      }
#pragma unroll
      for (int e = 0; e < R; ++e) acc[q][e] = acc[q][e] + tot[e];
    }
    mbar_arrive(empty + slot);
  }
}

// accumulator e of a warpgroup's m64nBN fragment: row 16 warp + lane / 4 + 8
// ((e / 2) % 2), column 8 (e / 4) + 2 (lane % 4) + e % 2
__device__ __forceinline__ int frag_row(int lt, int e) {
  return 16 * (lt >> 5) + ((lt & 31) >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int lt, int e) {
  return 8 * (e >> 2) + 2 * (lt & 3) + (e & 1);
}

// C (M, N) = A @ B at the format, both as stored planes (tile of blockIdx.x,
// M first).  Threads 0..255: two consumer warpgroups; 256..383: the
// producer warpgroup, whose first thread keeps the TMA loads in flight
// through full / empty mbarriers.  Planes at or past a stack's stored count (nsa,
// nsb) are zero-filled once and their products run like any other.
template <int NL, int NO>
__global__ void __launch_bounds__(BP_T, 1)
    both_tma_kernel(const __grid_constant__ BothMaps maps, const BothArgs t) {
  using T = Bt<NL, NO>;
  constexpr int BM = T::BM, BN = T::BN, R = T::R, ST = T::ST;
  extern __shared__ unsigned char bp_raw[];
  unsigned char* const ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(bp_raw) + HALIGN - 1) &
      ~(uintptr_t)(HALIGN - 1));
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + ST * T::STAGE);
  uint64_t* const empty = full + ST;
  const int mt = (t.M + BM - 1) / BM;
  const int m0 = (int)(blockIdx.x % mt) * BM;
  const int n0 = (int)(blockIdx.x / mt) * BN;
  const int stages = (t.K + KC - 1) / KC;
  const int tid = threadIdx.x;

  if (tid == BP_CT) {
    for (int r = 0; r < ST; ++r) {
      mbar_init(full + r);
      mbar_init(empty + r, BP_CT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the planes past the stored counts: zeros, never loaded
  for (int r = 0; r < ST; ++r) {
    unsigned char* const st = ring + r * T::STAGE;
    for (int i = t.nsa; i < NL; ++i)
      for (int x = tid; x < (int)(T::PA / 16); x += BP_T)
        reinterpret_cast<uint4*>(st + i * T::PA)[x] = make_uint4(0, 0, 0, 0);
    for (int j = t.nsb; j < NL; ++j)
      for (int x = tid; x < (int)(T::PB / 16); x += BP_T)
        reinterpret_cast<uint4*>(st + NL * T::PA + j * T::PB)[x] =
            make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // the role by warpgroup, uniform across each warp (a shuffle from lane
  // 0): the consumers' code is then compiled as one warpgroup's (9-20%
  // faster than on tid >= BP_CT, PERF.md)
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 2) {
    // the producer: A's planes K-major (boxes of KC k x BM rows), B's
    // N-major (boxes of 64 columns x KC k), 128-byte swizzle, into slot s %
    // ST once both warpgroups have released its last stage
    if (tid == BP_CT) {
      const int bytes = (int)(t.nsa * T::PA + t.nsb * T::PB);
#pragma unroll 1
      for (int s = 0; s < stages; ++s) {
        const int slot = s % ST;
        if (s >= ST) mbar_wait(empty + slot, ((s / ST) + 1) & 1);
        unsigned char* const st = ring + slot * T::STAGE;
        mbar_expect(full + slot, bytes);
        for (int i = 0; i < t.nsa; ++i)
          tma_load3(st + i * T::PA, &maps.a, s * KC, m0, i, full + slot);
        for (int j = 0; j < t.nsb; ++j)
#pragma unroll
          for (int q = 0; q < T::ATOMS; ++q)
            tma_load3(st + NL * T::PA + j * T::PB + q * 64 * KC * 2, &maps.b,
                      n0 + 64 * q, s * KC, j, full + slot);
      }
    }
  } else {
    const int lt = tid & 127;
    float acc[T::NACC][R];
    float* const xch = reinterpret_cast<float*>(ring);
    if (T::OS && wgi == 1) {
      // the order split's warpgroup 1: its orders over the tile's 64 rows,
      // then its sums to warpgroup 0 through the ring (free once both are
      // done)
      bp_consume<NL, NO, 1>(ring, full, empty, stages, 0, acc);
      bar_sync(BAR_BP_DONE, BP_CT);
#pragma unroll
      for (int q = 0; q < bp_count(NO, 1); ++q)
#pragma unroll
        for (int e = 0; e < R; ++e) xch[(q * R + e) * 128 + lt] = acc[q][e];
      bar_arrive(BAR_BP_X, BP_CT);
    } else {
      // the order split's warpgroup 0 (its orders, then every order joined
      // from the highest down), or the row split's warpgroup wgi (rows 64
      // wgi .. 64 wgi + 63, every order)
      const int row0 = T::OS ? 0 : 64 * wgi;
      bp_consume<NL, NO, 0>(ring, full, empty, stages, row0 * KC * 2,
                               acc);
      if constexpr (T::OS) {
        bar_sync(BAR_BP_DONE, BP_CT);
        bar_sync(BAR_BP_X, BP_CT);
      }
#pragma unroll
      for (int e = 0; e < R; ++e) {
        const int64_t gm = m0 + row0 + frag_row(lt, e);
        const int64_t gn = n0 + frag_col(lt, e);
        if (gm >= t.M || gn >= t.N) continue;
        float per_order[NO];
        if constexpr (T::OS) {
#pragma unroll
          for (int q = 0; q < bp_count(NO, 0); ++q)
            per_order[bp_order(NO, 0, q)] = acc[q][e];
#pragma unroll
          for (int q = 0; q < bp_count(NO, 1); ++q)
            per_order[bp_order(NO, 1, q)] = xch[(q * R + e) * 128 + lt];
        } else {
#pragma unroll
          for (int o = 0; o < NO; ++o) per_order[o] = acc[o][e];
        }
        t.C[gm * t.c_sr + gn] = combine_orders<NO>(per_order, NO - 1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The decode tile.

constexpr int SPLIT_MAX = 8;   // the portable cluster size

// The split decode tile's arguments: the fused matmul's (its f32 weight in
// m.b), or the pre-limbed matmul's (PL: A, C, strides and sizes in m, batch
// 1, its stored planes in bp); the mixed-lane matmul's add each row's lane
// (MixedDecodeArgs); the projection's are its ProjArgs
struct DecodeArgs {
  MatmulArgs m;
  Planes bp;
};

struct MixedDecodeArgs {
  DecodeArgs d;
  const int32_t* lane_n;    // (M,) limbs of each row's lane
  const int32_t* lane_ord;  // (M,) order cut of each row's lane
};

__device__ __forceinline__ const DecodeArgs& dec_of(const DecodeArgs& d) {
  return d;
}
__device__ __forceinline__ const DecodeArgs& dec_of(const MixedDecodeArgs& d) {
  return d.d;
}

// the argument struct of each epilogue: the projection's ProjArgs, else the
// matmuls' (LN: with the lanes)
template <Epi EPI, bool LN>
using SplitArgs =
    std::conditional_t<EPI == Epi::PROJ, ProjArgs,
                       std::conditional_t<LN, MixedDecodeArgs, DecodeArgs>>;

// fused_matmul_kernel's decode tile as one block per DEC_N columns and batch
// entry (S = 1): mp_matmul_common.cuh's decode_tile as it is
template <int NL, int NO, bool GEN, bool PARTS>
__global__ void __launch_bounds__(DEC_CT + 128)
    fused_matmul_decode_kernel(MatmulArgs p, int dk) {
  const int64_t z0 = blockIdx.z / p.nb1, z1 = blockIdx.z % p.nb1;
  const float* const B[1] = {p.b + z0 * p.b_sb0 + z1 * p.b_sb1};
  float* const C = p.c + z0 * p.c_sb0 + z1 * p.c_sb1;
  const float* const A = p.a + z0 * p.a_sb0 + z1 * p.a_sb1;
  const int64_t n0 = (int64_t)blockIdx.x * DEC_N;
  if constexpr (PARTS) {
    const int mo = GEN ? p.max_order : NO - 1;
    decode_tile<NL, NO, GEN, false, false, 1, true>(
        A, p.a_sr, p.a_sc, B, p.b_sr, p.b_sc, Planes{}, (int)p.M, p.N, p.K,
        p.n_limbs, p.max_order, dk, nullptr, nullptr,
        [&](int r, int64_t gn, const float (&po)[NO]) {
#pragma unroll
          for (int o = 0; o < NO; ++o)
            if (o <= mo) C[o * p.c_so + r * p.c_sr + gn * p.c_sc] = po[o];
        },
        n0);
  } else {
    decode_tile<NL, NO, GEN, false>(
        A, p.a_sr, p.a_sc, B, p.b_sr, p.b_sc, Planes{}, (int)p.M, p.N, p.K,
        p.n_limbs, p.max_order, dk, nullptr, nullptr,
        [&](int r, int64_t gn, const float (&y)[1]) {
          C[r * p.c_sr + gn * p.c_sc] = y[0];
        },
        n0);
  }
}

// the pre-limbed matmul's decode tile as one block per DEC_N columns (S =
// 1, as at lm_head's 2,000 slabs): mp_matmul.cu's old decode tile as it
// was, its stored planes by cp.async.  (With its arguments in DecodeArgs
// it measured 9% slower at lm_head, PERF.md.)
template <int NL, int NO, bool GEN>
__global__ void __launch_bounds__(DEC_CT + 128)
    prelimbed_matmul_decode_kernel(PrelimbedArgs p, int dk) {
  const float* const B[1] = {nullptr};
  decode_tile<NL, NO, GEN, true>(
      p.a, p.a_sr, 1, B, 0, 0, p.b, (int)p.M, p.N, p.K, p.n_limbs,
      p.max_order, dk, nullptr, nullptr,
      [&](int r, int64_t gn, const float (&y)[1]) {
        p.c[r * p.c_sr + gn] = y[0];
      },
      (int64_t)blockIdx.x * DEC_N);
}

// the mixed-lane matmul's decode tile as one block per DEC_N columns (S =
// 1): mp_matmul.cu's old tile as it was, with its own MixedPrelimbedArgs.
// The envelope's planes stream once for all rows and the MMAs run at the
// envelope; each row selects its own terms.
template <int NL, int NO, bool GEN>
__global__ void __launch_bounds__(DEC_CT + 128)
    mixed_prelimbed_matmul_decode_kernel(MixedPrelimbedArgs p, int dk) {
  const float* const B[1] = {nullptr};
  decode_tile<NL, NO, GEN, true, true>(
      p.m.a, p.m.a_sr, 1, B, 0, 0, p.m.b, (int)p.m.M, p.m.N, p.m.K,
      p.m.n_limbs, p.m.max_order, dk, p.lane_n, p.lane_ord,
      [&](int r, int64_t gn, const float (&y)[1]) {
        p.m.c[r * p.m.c_sr + gn] = y[0];
      },
      (int64_t)blockIdx.x * DEC_N);
}

// the projection's decode tile as one block per (DEC_N columns, NOUT
// weights) (S = 1): A limbed once per stage for the block's weights t0 =
// blockIdx.y * NOUT onwards, then proj_store; mp_matmul.cu's old tile as it
// was.  The swiglu gate needs g and u of one output in one thread, so it
// runs NOUT = 2.
template <int NL, int NO, int NOUT, bool GEN>
__global__ void __launch_bounds__(DEC_CT + 128)
    fused_proj_decode_kernel(ProjArgs p, int dk) {
  const int t0 = (int)blockIdx.y * NOUT;
  const float* B[NOUT];
#pragma unroll
  for (int t = 0; t < NOUT; ++t) B[t] = p.b[t0 + t];
  decode_tile<NL, NO, GEN, false, false, NOUT>(
      p.a, p.a_sr, 1, B, p.b_sr, 1, Planes{}, (int)p.M, p.N, p.K, p.n_limbs,
      p.max_order, dk, nullptr, nullptr,
      [&](int r, int64_t gn, float (&y)[NOUT]) {
        proj_store<NOUT>(p, r, gn, t0, y);
      },
      (int64_t)blockIdx.x * DEC_N);
}

// The cluster-split decode tile: block x = slab * S + rank of a cluster of
// S blocks; rank r runs chunks [r cpr, (r + 1) cpr) of K into its tot_c at
// byte tot_off of the dynamic shared memory, then the cluster joins them:
// each output's acc[t][o] = ((+0.0 + tot_0) + tot_1) + ... in chunk order,
// then the epilogue.  EPI: COMBINE (the fused and pre-limbed matmuls: the
// combined sum; LN: each row from its own order cut down), PARTS (the
// per-order sums, uncombined) or PROJ (the projection: NOUT weights t0 =
// blockIdx.y * NOUT onwards, combined, then proj_store).  PL: B is the
// stored planes, fed by TMA through ``bmap`` (k counted from 0 of the whole
// K: the rank's boxes start at its first k).
template <int NL, int NO, bool GEN, int NOUT, Epi EPI, bool PL, bool LN>
__global__ void __launch_bounds__(DEC_CT + 128)
    matmul_split_kernel(const SplitArgs<EPI, LN> d,
                        const __grid_constant__ CUtensorMap bmap, int dk,
                        int S, int cpr, int tot_off) {
  static_assert(EPI == Epi::PROJ ? !PL && !LN : NOUT == 1,
                "the projection's f32 weights, the matmuls' one weight");
  static_assert(EPI != Epi::PARTS || !LN, "the partials have no lanes");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t n0 = (int64_t)(blockIdx.x / S) * DEC_N;
  // the block's operands: the projection's weights t0 onwards, or the
  // matmul's batch entry blockIdx.z
  const float* A;
  const float* B[NOUT];
  int64_t a_sr, a_sc = 1, b_sr = 0, b_sc = 1, M, N, K;
  int n_limbs, max_order, t0 = 0;
  Planes bp{};
  const int32_t* ln = nullptr;
  const int32_t* lo = nullptr;
  float* C = nullptr;
  int64_t c_sr = 0, c_sc = 1, c_so = 0;
  if constexpr (EPI == Epi::PROJ) {
    t0 = (int)blockIdx.y * NOUT;
    A = d.a;
    a_sr = d.a_sr;
#pragma unroll
    for (int t = 0; t < NOUT; ++t) B[t] = d.b[t0 + t];
    b_sr = d.b_sr;
    M = d.M;
    N = d.N;
    K = d.K;
    n_limbs = d.n_limbs;
    max_order = d.max_order;
  } else {
    const MatmulArgs& p = dec_of(d).m;
    const int64_t z0 = blockIdx.z / p.nb1, z1 = blockIdx.z % p.nb1;
    A = p.a + z0 * p.a_sb0 + z1 * p.a_sb1;
    a_sr = p.a_sr;
    a_sc = p.a_sc;
    B[0] = PL ? nullptr : p.b + z0 * p.b_sb0 + z1 * p.b_sb1;
    b_sr = p.b_sr;
    b_sc = p.b_sc;
    bp = dec_of(d).bp;
    M = p.M;
    N = p.N;
    K = p.K;
    n_limbs = p.n_limbs;
    max_order = p.max_order;
    C = p.c + z0 * p.c_sb0 + z1 * p.c_sb1;
    c_sr = p.c_sr;
    c_sc = p.c_sc;
    c_so = p.c_so;
    if constexpr (LN) {
      ln = d.lane_n;
      lo = d.lane_ord;
    }
  }
  const int64_t kb = (int64_t)rank * cpr * KC;
  const int64_t ke = kb + (int64_t)cpr * KC < K ? kb + (int64_t)cpr * KC : K;
  const int64_t kl = ke > kb ? ke - kb : 0;
  // the rank's k rows (the planes' for copies; TMA counts from 0)
  const float* Bk[NOUT];
#pragma unroll
  for (int t = 0; t < NOUT; ++t) Bk[t] = PL ? nullptr : B[t] + kb * b_sr;
  bp.p += kb * bp.sr;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  float* const tots = reinterpret_cast<float*>(dec_smem + tot_off);
  decode_tile<NL, NO, GEN, PL, LN, NOUT, false, true>(
      A + kb * a_sc, a_sr, a_sc, Bk, b_sr, b_sc, bp, (int)M, N, kl, n_limbs,
      max_order, dk, ln, lo, [](int, int64_t, const float (&)[NOUT]) {}, n0,
      tots, &bmap, (int)kb);
  cluster.sync();   // every rank's chunk sums are written
  const int mo = GEN ? max_order : NO - 1;
  const int nch = (int)((K + KC - 1) / KC);
  for (int idx = rank + S * (int)threadIdx.x; idx < DEC_M * DEC_N;
       idx += S * (int)blockDim.x) {
    const int r = idx / DEC_N;
    const int64_t gn = n0 + idx % DEC_N;
    if (r >= M || gn >= N) continue;
    float y[NOUT];
#pragma unroll
    for (int t = 0; t < NOUT; ++t) {
      float per_order[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        float a = 0.f;   // the single block's acc[t][o], chunk by chunk
        if (o <= mo) {
#pragma unroll 4
          for (int c = 0; c < nch; ++c) {
            const float* const tt = cluster.map_shared_rank(tots, c / cpr);
            a = a + tt[(((c % cpr) * NOUT + t) * NO + o) * DEC_M * DEC_N +
                       idx];
          }
        }
        per_order[o] = a;
      }
      if constexpr (EPI == Epi::PARTS) {
#pragma unroll
        for (int o = 0; o < NO; ++o)
          if (o <= mo) C[o * c_so + r * c_sr + gn * c_sc] = per_order[o];
      } else {
        // a lane row joins its own orders, from its own highest one down
        y[t] = combine_orders<NO>(per_order, LN ? lo[r] : mo);
      }
    }
    if constexpr (EPI == Epi::PROJ)
      proj_store<NOUT>(d, r, gn, t0, y);
    else if constexpr (EPI == Epi::COMBINE)
      C[r * c_sr + gn * c_sc] = y[0];
  }
  cluster.sync();   // no rank leaves while another reads its sums
}

// The cluster size S as the split tile runs it: every rank at least one of
// K's chunks, S = ceil(chunks / ceil(chunks / s)).
__host__ __device__ inline int split_norm(int64_t nch, int s) {
  if (nch <= 1 || s <= 1) return 1;
  if (s > nch) s = (int)nch;
  const int64_t cpr = (nch + s - 1) / s;
  return (int)((nch + cpr - 1) / cpr);
}

// the split tile's shared memory for a rank's K range kr at dk k per
// stage and nout weights a block: the decode tile's (pl: on stored planes,
// with the TMA ring's slack; 16-aligned), then the chunk sums of cpr chunks
__host__ __device__ inline int64_t split_tot_off(bool pl, int nl, int M,
                                                 int64_t kr, int dk,
                                                 int nout) {
  const int64_t stages = dk > 0 ? (kr + dk - 1) / dk : 0;
  const int slots = (int)(stages < DecRing<1>::S ? stages : DecRing<1>::S);
  return (dec_split_bytes(pl, nl, M, dk, slots, nout) + 15) / 16 * 16;
}

__host__ __device__ inline int64_t split_smem_bytes(bool pl, int nl, int no,
                                                    int M, int64_t kr, int dk,
                                                    int cpr, int nout) {
  return split_tot_off(pl, nl, M, kr, dk, nout) +
         (int64_t)cpr * nout * no * DEC_M * DEC_N * 4;
}

// the split tile's k per stage for a rank's K range: the ring's most
// (ring_k), or the range rounded up to KC when shorter, halved in
// multiples of KC until the block fits the card's opt-in shared memory
__host__ __device__ inline int split_dk(bool pl, int nl, int no, int M,
                                        int64_t kr, int cpr, int nout,
                                        int ring_k, int64_t optin) {
  int dk = (int)(kr < ring_k ? (kr + KC - 1) / KC * KC : ring_k);
  while (dk > KC && split_smem_bytes(pl, nl, no, M, kr, dk, cpr, nout) > optin)
    dk = (dk / 2 + KC - 1) / KC * KC;
  return dk;
}

// blocks of the split tile an SM holds by registers: ``regs`` a thread (the
// instantiation's, ptxas's count; at least 64, in the allocation's steps of
// 8): at 64, 5 of the f32 weight's 192 threads, 8 of the stored planes'
// 128 (their producers only copy)
__host__ __device__ constexpr int split_per_sm(bool pl, int regs) {
  return 65536 / ((DEC_CT + 32 * DecRing<1>::P(pl)) *
                  (regs < 64 ? 64 : (regs + 7) / 8 * 8));
}

// The decode plan: the largest cluster size S (<= SPLIT_MAX, as the tile
// runs it) whose S blocks per 16-column slab (slabs: the launch's slabs
// times grid.y and the batch) all fit on the card at once at split_dk's
// stage or, failing that, at a shorter one (halved down to KC): blocks per
// SM by shared memory, by threads and by the kernel's registers
// (split_per_sm).  On f32 weights, which the block limbs stage by stage, a
// rank must also run fewer stages than the single block (dec_stage_k's)
// where that one runs more than one: a shorter stage that keeps their
// count only adds the cluster's join (the gated projection at M8, 0.0201
// ms at (64, 2) against 0.0187 at one block, PERF.md).  pl: B as stored
// bf16 planes (their ring, not the f32 weights'); nout: weights a block.
// Returns S and its stage in *dk; S = 1 (*dk = 0: launch_decode's choice)
// where no S fits, as at lm_head's 2,000 slabs: the single-block decode
// tile.
__host__ __device__ inline int split_plan(bool pl, int64_t slabs, int64_t K,
                                          int nl, int no, int M, int nout,
                                          int regs, int ring_k, int sms,
                                          int64_t sm_smem, int64_t optin,
                                          int* dk) {
  const int64_t nch = (K + KC - 1) / KC;
  const int d1 = dec_stage_k(pl, nl, M, K, nout, slabs, ring_k, sms,
                             sm_smem, optin);
  const int64_t st1 = pl ? 0 : (K + d1 - 1) / d1;
  for (int s = SPLIT_MAX; s > 1; --s) {
    if (split_norm(nch, s) != s) continue;   // a smaller s runs as this one
    const int cpr = (int)((nch + s - 1) / s);
    const int64_t kr = (int64_t)cpr * KC;
    for (int d = split_dk(pl, nl, no, M, kr, cpr, nout, ring_k, optin);;
         d = (d / 2 + KC - 1) / KC * KC) {
      if (st1 > 1 && (kr + d - 1) / d >= st1) break;
      const int64_t smem = split_smem_bytes(pl, nl, no, M, kr, d, cpr, nout);
      int64_t per_sm = sm_smem / (smem + 1024);   // 1 KB is the runtime's
      if (per_sm > split_per_sm(pl, regs)) per_sm = split_per_sm(pl, regs);
      if (smem <= optin && s * slabs <= per_sm * sms) {
        *dk = d;
        return s;
      }
      if (d <= KC) break;
    }
  }
  *dk = 0;
  return 1;
}

// a kernel's registers a thread (ptxas's count), read once
template <auto kernel>
int kernel_regs() {
  static int regs = 0;
  if (regs == 0) {
    cudaFuncAttributes a;
    if (cudaFuncGetAttributes(&a, kernel) == cudaSuccess) regs = a.numRegs;
  }
  return regs;
}

// ---------------------------------------------------------------------------
// Tensor maps and the prefill launch.

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 4-d f32 map (inner, rows, nb1, nb0), strides in elements, a box of
// (box_inner, box_rows, 1, 1), zeros past every edge; the stride of a batch
// dim of size 1 is never used and set to a legal one
bool make_map(CUtensorMap* map, const float* base, int64_t inner,
              int64_t rows, int64_t sr, int64_t nb1, int64_t sb1,
              int64_t nb0, int64_t sb0, int box_inner, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int64_t s1 = nb1 > 1 ? sb1 : sr * rows;
  const int64_t s2 = nb0 > 1 ? sb0 : s1 * nb1;
  cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)rows,
                        (cuuint64_t)nb1, (cuuint64_t)nb0};
  cuuint64_t strides[3] = {(cuuint64_t)sr * 4, (cuuint64_t)s1 * 4,
                           (cuuint64_t)s2 * 4};
  cuuint32_t box[4] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1, 1};
  cuuint32_t es[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
            const_cast<float*>(base), dims, strides, box, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// what a tensor map can read: unit column stride, 16-byte aligned base and
// strides (a batch dim of size 1 excepted), sizes within 32 bits
bool tma_operand(const void* base, int64_t sc, int64_t sr, int64_t nb1,
                 int64_t sb1, int64_t nb0, int64_t sb0) {
  auto ok = [](int64_t s) { return s > 0 && s % 4 == 0 && s < (1LL << 38); };
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && sc == 1 && ok(sr) &&
         (nb1 == 1 || ok(sb1)) && (nb0 == 1 || ok(sb0));
}

// the stored planes a tensor map reads (make_planes_map's layout): rows and
// plane stride a multiple of 16 bytes, a 16-byte aligned base, K and N
// within 31 bits
bool planes_mappable(const Planes& bp, int nst, int64_t N, int64_t K) {
  auto ok = [](int64_t s) { return s > 0 && s % 8 == 0 && s < (1LL << 39); };
  return reinterpret_cast<uintptr_t>(bp.p) % 16 == 0 && ok(bp.sr) &&
         (nst <= 1 || ok(bp.plane)) && N <= INT32_MAX && K <= INT32_MAX;
}

// the stored planes (nst of them, a plane stride of ``plane`` and a row
// stride of ``sr`` elements, bf16, ``inner`` columns of ``rows`` rows) as a
// 3-d map (inner, rows, plane) with a box of box_inner x box_rows in the
// given swizzle, zeros past every edge; false where a map cannot read them
// (the planes' rows or plane stride off 16 bytes, a misaligned base).  The
// decode tile reads B's planes in boxes of DEC_N columns x dk k in the
// 32-byte swizzle (its dec_col layout), the both-prelimbed tile both
// operands' in the 128-byte swizzle wgmma reads.
bool make_planes_map(CUtensorMap* map, const Planes& p, int nst,
                     int64_t inner, int64_t rows, int box_inner, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || !planes_mappable(p, nst, inner, rows)) return false;
  const int64_t plane = nst > 1 ? p.plane : p.sr * rows;
  cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                        (cuuint64_t)nst};
  cuuint64_t strides[2] = {(cuuint64_t)p.sr * 2, (cuuint64_t)plane * 2};
  cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  cuuint32_t es[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<__nv_bfloat16*>(p.p), dims, strides, box, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One split launch: S ranks a slab and dk k per stage, each rank cpr of K's
// chunks, dynamic shared memory smem with the chunk sums at tot_off
struct SplitPlan {
  int S = 1, dk = 0, cpr = 0, tot_off = 0;
  int64_t smem = 0;
};

// The split tile's launch for K at M rows, nout weights a block and slabs
// 16-column slabs (times grid.y and the batch): the plan's S on the
// kernel's registers (or the tuner's s_req) and k per stage (split_dk's for
// the rank's K range, or the tuner's dk_req).  splittable false (stored
// planes no tensor map reads) plans S = 1.  S = 1: the caller runs the
// single-block tile (at dk_req, or launch_decode's choice).
template <int NL, auto kernel>
cudaError_t split_choose(bool pl, int nl, int no, int nout, int64_t M,
                         int64_t K, int64_t slabs, bool splittable,
                         int dk_req, int s_req, SplitPlan* sp) {
  Card cd;
  cudaError_t err = card(cd);
  if (err != cudaSuccess) return err;
  const int64_t nch = (K + KC - 1) / KC;
  if (s_req > SPLIT_MAX || (s_req > 1 && !splittable))
    return cudaErrorInvalidValue;
  int plan_dk = 0;
  sp->S = s_req > 0 ? split_norm(nch, s_req)
          : splittable
              ? split_plan(pl, slabs, K, nl, no, (int)M, nout,
                           kernel_regs<kernel>(), DecRing<NL>::K, cd.sms,
                           cd.sm_smem, cd.optin, &plan_dk)
              : 1;
  if (sp->S == 1) return cudaSuccess;
  sp->cpr = (int)((nch + sp->S - 1) / sp->S);
  const int64_t kr = (int64_t)sp->cpr * KC;
  sp->dk = plan_dk > 0 ? plan_dk
                       : split_dk(pl, nl, no, (int)M, kr, sp->cpr, nout,
                                  DecRing<NL>::K, cd.optin);
  if (dk_req > 0) {
    if (dk_req % KC || dk_req > DecRing<NL>::K ||
        split_smem_bytes(pl, nl, no, (int)M, kr, dk_req, sp->cpr, nout) >
            cd.optin)
      return cudaErrorInvalidValue;
    sp->dk = dk_req;
  }
  sp->smem = split_smem_bytes(pl, nl, no, (int)M, kr, sp->dk, sp->cpr, nout);
  if (sp->smem > cd.optin) return cudaErrorInvalidValue;
  sp->tot_off = (int)split_tot_off(pl, nl, (int)M, kr, sp->dk, nout);
  return cudaSuccess;
}

// Launch the split kernel on the plan: grid (nx S, ny, nz), clusters of S
// along x, DecRing's producer warps (pl: two, they only copy); the kernel's
// dynamic shared memory limit is raised to the card's once per kernel.
template <int NL, auto kernel, typename Args>
cudaError_t split_go(const Args& d, const CUtensorMap& bmap, bool pl,
                     int64_t nx, unsigned ny, int64_t nz, const SplitPlan& sp,
                     cudaStream_t st) {
  Card cd;
  cudaError_t err = card(cd);
  if (err != cudaSuccess) return err;
  static bool raised = false;
  if (!raised) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cd.optin);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nx * sp.S), ny, (unsigned)nz);
  cfg.blockDim = dim3(DEC_CT + 32 * DecRing<NL>::P(pl), 1, 1);
  cfg.dynamicSmemBytes = (size_t)sp.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)sp.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, d, bmap, sp.dk, sp.S, sp.cpr,
                           sp.tot_off);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// M <= DEC_M, the fused matmul (PARTS: its partials) and the pre-limbed
// matmul (PL, batch 1: the stored planes d.bp, by TMA; planes no map reads
// plan S = 1, whose cp.async copies take any layout, with the same bits)
template <int NL, int NO, bool GEN, bool PARTS, bool PL>
cudaError_t launch_split(const DecodeArgs& d, int64_t nb0, int dk_req,
                         int s_req, cudaStream_t st) {
  constexpr Epi EPI = PARTS ? Epi::PARTS : Epi::COMBINE;
  constexpr auto kernel = matmul_split_kernel<NL, NO, GEN, 1, EPI, PL, false>;
  const MatmulArgs& p = d.m;
  const int nl = GEN ? p.n_limbs : NL;
  const int64_t nz = nb0 * p.nb1;
  const int64_t nx = (p.N + DEC_N - 1) / DEC_N;
  const int nst = PL ? (d.bp.n_stored < nl ? d.bp.n_stored : nl) : 0;
  SplitPlan sp;
  cudaError_t err = split_choose<NL, kernel>(
      PL, nl, NO, 1, p.M, p.K, nx * nz,
      !PL || planes_mappable(d.bp, nst, p.N, p.K), dk_req, s_req, &sp);
  if (err != cudaSuccess) return err;
  if (sp.S == 1) {
    if constexpr (PL) {
      const PrelimbedArgs q{p.a, d.bp, p.c, p.a_sr, p.c_sr,
                            p.M, p.N, p.K, p.n_limbs, p.max_order};
      return launch_decode<NL, 1, prelimbed_matmul_decode_kernel<NL, NO, GEN>>(
          q, true, nl, p.M, p.N, p.K, 1, 1, dk_req, st);
    } else {
      return launch_decode<NL, 1,
                           fused_matmul_decode_kernel<NL, NO, GEN, PARTS>>(
          p, false, nl, p.M, p.N, p.K, 1, nz, dk_req, st);
    }
  }
  CUtensorMap bmap;
  memset(&bmap, 0, sizeof(bmap));
  if (PL && !make_planes_map(&bmap, d.bp, nst, p.N, p.K, DEC_N, sp.dk,
                            CU_TENSOR_MAP_SWIZZLE_32B))
    return cudaErrorInvalidValue;
  return split_go<NL, kernel>(d, bmap, PL, nx, 1, nz, sp, st);
}

// M <= DEC_M, the mixed-lane matmul: as the pre-limbed matmul's, each row
// at its lane; S = 1 runs mixed_prelimbed_matmul_decode_kernel on its own
// MixedPrelimbedArgs
template <int NL, int NO, bool GEN>
cudaError_t launch_mixed_split(const MixedDecodeArgs& d, int dk_req,
                               int s_req, cudaStream_t st) {
  constexpr auto kernel =
      matmul_split_kernel<NL, NO, GEN, 1, Epi::COMBINE, true, true>;
  const MatmulArgs& p = d.d.m;
  const int nl = GEN ? p.n_limbs : NL;
  const int64_t nx = (p.N + DEC_N - 1) / DEC_N;
  const int nst = d.d.bp.n_stored < nl ? d.d.bp.n_stored : nl;
  SplitPlan sp;
  cudaError_t err = split_choose<NL, kernel>(
      true, nl, NO, 1, p.M, p.K, nx, planes_mappable(d.d.bp, nst, p.N, p.K),
      dk_req, s_req, &sp);
  if (err != cudaSuccess) return err;
  if (sp.S == 1) {
    const MixedPrelimbedArgs q{{p.a, d.d.bp, p.c, p.a_sr, p.c_sr, p.M, p.N,
                                p.K, p.n_limbs, p.max_order},
                               d.lane_n,
                               d.lane_ord};
    return launch_decode<NL, 1,
                         mixed_prelimbed_matmul_decode_kernel<NL, NO, GEN>>(
        q, true, nl, p.M, p.N, p.K, 1, 1, dk_req, st);
  }
  CUtensorMap bmap;
  memset(&bmap, 0, sizeof(bmap));
  if (!make_planes_map(&bmap, d.d.bp, nst, p.N, p.K, DEC_N, sp.dk,
                       CU_TENSOR_MAP_SWIZZLE_32B))
    return cudaErrorInvalidValue;
  return split_go<NL, kernel>(d, bmap, true, nx, 1, 1, sp, st);
}

// M <= DEC_M, the projection: NOUT weights a block, ny blocks of weights
// (grid.y); S = 1 runs fused_proj_decode_kernel
template <int NL, int NO, bool GEN, int NOUT>
cudaError_t launch_proj_split(const ProjArgs& p, unsigned ny, int dk_req,
                              int s_req, cudaStream_t st) {
  constexpr auto kernel =
      matmul_split_kernel<NL, NO, GEN, NOUT, Epi::PROJ, false, false>;
  const int nl = GEN ? p.n_limbs : NL;
  const int64_t nx = (p.N + DEC_N - 1) / DEC_N;
  SplitPlan sp;
  cudaError_t err = split_choose<NL, kernel>(
      false, nl, NO, NOUT, p.M, p.K, nx * ny, true, dk_req, s_req, &sp);
  if (err != cudaSuccess) return err;
  if (sp.S == 1)
    return launch_decode<NL, NOUT,
                         fused_proj_decode_kernel<NL, NO, NOUT, GEN>>(
        p, false, nl, p.M, p.N, p.K, ny, 1, dk_req, st);
  CUtensorMap bmap;
  memset(&bmap, 0, sizeof(bmap));
  return split_go<NL, kernel>(p, bmap, false, nx, ny, 1, sp, st);
}

// The projection's decode tile: gated, both weights in a block (silu(g) * u
// needs g and u of one output in one thread); else one weight a block, the
// grid walking QKV's weights (grid.y = n_out: QKV 8x768 M8 0.0097 ms
// against 0.0116 with the three weights in one cluster, A limbed once,
// PERF.md)
template <int NL, int NO, bool GEN>
cudaError_t launch_proj_decode(const ProjArgs& p, int n_out, int dk_req,
                               int s_req, cudaStream_t st) {
  if (p.gate)
    return launch_proj_split<NL, NO, GEN, 2>(p, 1, dk_req, s_req, st);
  return launch_proj_split<NL, NO, GEN, 1>(p, (unsigned)n_out, dk_req, s_req,
                                           st);
}

// Launch one prefill-tile kernel: NOUT weights a block, ny blocks of
// weights (grid.y), nz batch entries (grid.z); the kernel's dynamic shared
// memory limit is raised to the tile's need once per kernel.
template <int NL, int NO, int NOUT, bool GEN, Epi EPI>
cudaError_t launch_tma_kernel(const TmaMaps& maps, const TmaArgs& t,
                              unsigned ny, unsigned nz, cudaStream_t st) {
  using H = Hp<NL, NO, NOUT>;
  auto kernel = tma_matmul_kernel<NL, NO, NOUT, GEN, EPI>;
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)H::SMEM);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const int64_t tiles =
      (((int64_t)t.M + HM - 1) / HM) * (((int64_t)t.N + H::BN - 1) / H::BN);
  const dim3 grid((unsigned)tiles, ny, nz);
  kernel<<<grid, H::HT, (size_t)H::SMEM, st>>>(maps, t);
  return cudaGetLastError();
}

template <int NL, int NO, bool GEN, bool PARTS>
cudaError_t launch_tma(const MatmulArgs& p, int64_t nb0, cudaStream_t st) {
  constexpr int BN = Hp<NL, NO>::BN;
  if (p.K < 1 || p.M > INT32_MAX || p.N > INT32_MAX || p.K > INT32_MAX ||
      p.nb1 > INT32_MAX ||
      !tma_operand(p.a, p.a_sc, p.a_sr, p.nb1, p.a_sb1, nb0, p.a_sb0) ||
      !tma_operand(p.b, p.b_sc, p.b_sr, p.nb1, p.b_sb1, nb0, p.b_sb0))
    return cudaErrorInvalidValue;
  TmaMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (!make_map(&maps.a, p.a, p.K, p.M, p.a_sr, p.nb1, p.a_sb1, nb0, p.a_sb0,
                KC, HM) ||
      !make_map(&maps.b[0], p.b, p.N, p.K, p.b_sr, p.nb1, p.b_sb1, nb0,
                p.b_sb0, BN, KC))
    return cudaErrorInvalidValue;
  TmaArgs t{};
  t.C = p.c;
  t.c_sb0 = p.c_sb0;
  t.c_sb1 = p.c_sb1;
  t.c_sr = p.c_sr;
  t.c_sc = p.c_sc;
  t.c_so = p.c_so;
  t.nb1 = (int)p.nb1;
  t.M = (int)p.M;
  t.N = (int)p.N;
  t.K = (int)p.K;
  t.n_limbs = p.n_limbs;
  t.max_order = p.max_order;
  return launch_tma_kernel<NL, NO, 1, GEN, PARTS ? Epi::PARTS : Epi::COMBINE>(
      maps, t, 1, (unsigned)(nb0 * p.nb1), st);
}

// The projection's prefill tile: A's map and one per weight.  Gated, both
// weights in one block (silu(g) * u needs g and u of one output in one
// thread).  Ungated, the three weights of QKV in one block where its tile
// keeps 24 columns or more (M8's 48, M16's 24: A limbed once for the
// three, and fewer tiles than waves of one per weight), else the grid
// walks the weights, one a block (grid.y = n_out): at M23 one block's 8
// columns measured 2.1x slower, at two weights (gate / up at M16) 7%
// slower (PERF.md).
template <int NL, int NO, bool GEN>
cudaError_t launch_tma_proj(const ProjArgs& p, int n_out, cudaStream_t st) {
  constexpr int NW = 2;   // the gated block's weights
  constexpr bool ONE3 = hp_bn(3 * NO) >= 24;
  if (p.K < 1 || p.M > INT32_MAX || p.N > INT32_MAX || p.K > INT32_MAX ||
      !tma_operand(p.a, 1, p.a_sr, 1, 0, 1, 0))
    return cudaErrorInvalidValue;
  const int nw = p.gate ? NW : ONE3 && n_out == 3 ? 3 : 1;
  const int bn = hp_bn(nw * NO);
  TmaMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (!make_map(&maps.a, p.a, p.K, p.M, p.a_sr, 1, 0, 1, 0, KC, HM))
    return cudaErrorInvalidValue;
  for (int w = 0; w < n_out; ++w)
    if (!tma_operand(p.b[w], 1, p.b_sr, 1, 0, 1, 0) ||
        !make_map(&maps.b[w], p.b[w], p.N, p.K, p.b_sr, 1, 0, 1, 0, bn, KC))
      return cudaErrorInvalidValue;
  TmaArgs t{};
  t.nb1 = 1;
  t.M = (int)p.M;
  t.N = (int)p.N;
  t.K = (int)p.K;
  t.n_limbs = p.n_limbs;
  t.max_order = p.max_order;
  t.proj = p;
  if (nw == NW)
    return launch_tma_kernel<NL, NO, NW, GEN, Epi::PROJ>(maps, t, 1, 1, st);
  if constexpr (ONE3) {
    if (nw == 3)
      return launch_tma_kernel<NL, NO, 3, GEN, Epi::PROJ>(maps, t, 1, 1, st);
  }
  return launch_tma_kernel<NL, NO, 1, GEN, Epi::PROJ>(maps, t,
                                                      (unsigned)n_out, 1, st);
}

// The both-prelimbed tile: A's planes (M, K) and B's (K, N) by their maps;
// a layout no map reads, or K < 1, is refused (the caller routes those to
// mp_matmul.cu's tile before the launch)
template <int NL, int NO>
cudaError_t launch_both(const Planes& ap, const Planes& bp, float* c,
                        int64_t c_sr, int64_t M, int64_t N, int64_t K,
                        cudaStream_t st) {
  using T = Bt<NL, NO>;
  auto kernel = both_tma_kernel<NL, NO>;
  const int nsa = ap.n_stored < NL ? ap.n_stored : NL;
  const int nsb = bp.n_stored < NL ? bp.n_stored : NL;
  if (K < 1 || M > INT32_MAX || N > INT32_MAX || K > INT32_MAX)
    return cudaErrorInvalidValue;
  BothMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (!make_planes_map(&maps.a, ap, nsa, K, M, KC, T::BM,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_planes_map(&maps.b, bp, nsb, N, K, 64, KC,
                       CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const BothArgs t{c, c_sr, (int)M, (int)N, (int)K, nsa, nsb};
  const int64_t tiles = ((M + T::BM - 1) / T::BM) * ((N + T::BN - 1) / T::BN);
  kernel<<<(unsigned)tiles, BP_T, (size_t)T::SMEM, st>>>(maps, t);
  return cudaGetLastError();
}

template <int NL, int NO, bool GEN, bool PARTS>
cudaError_t launch_hopper(const MatmulArgs& p, int64_t nb0, int p0, int p1,
                          cudaStream_t st) {
  if (p.M <= DEC_M)
    return launch_split<NL, NO, GEN, PARTS, false>(DecodeArgs{p, Planes{}},
                                                   nb0, p0, p1, st);
  // the prefill tile takes no launch parameter, and its partials epilogue
  // only one limb (more limbs keep mp_matmul.cu's tile, faster there)
  if (p0 > 0 || p1 > 0) return cudaErrorInvalidValue;
  if constexpr (PARTS && NL != 1) {
    return cudaErrorInvalidValue;
  } else {
    return launch_tma<NL, NO, GEN, PARTS>(p, nb0, st);
  }
}

// the launch of a built-in format's instantiation, or the generic one's
#define MP_FOR_FORMAT(nl, mo, CALL)                            \
  do {                                                         \
    if ((nl) == 1 && (mo) == 0) return CALL(1, 1, false);      \
    if ((nl) == 2 && (mo) == 1) return CALL(2, 2, false);      \
    if ((nl) == 3 && (mo) == 2) return CALL(3, 3, false);      \
    if ((nl) == 5 && (mo) == 4) return CALL(5, 5, false);      \
    if ((nl) == 7 && (mo) == 6) return CALL(7, 7, false);      \
    return CALL(GEN_NL, GEN_NO, true);                         \
  } while (0)

template <bool PARTS>
cudaError_t hopper_for_format(const MatmulArgs& p, int64_t nb0, int p0,
                              int p1, cudaStream_t st) {
#define MP_CALL(NL, NO, GEN) launch_hopper<NL, NO, GEN, PARTS>(p, nb0, p0, p1, st)
  MP_FOR_FORMAT(p.n_limbs, p.max_order, MP_CALL);
#undef MP_CALL
}

cudaError_t proj_for_format(const ProjArgs& p, int n_out, cudaStream_t st) {
#define MP_CALL(NL, NO, GEN) launch_tma_proj<NL, NO, GEN>(p, n_out, st)
  MP_FOR_FORMAT(p.n_limbs, p.max_order, MP_CALL);
#undef MP_CALL
}

cudaError_t prelimbed_for_format(const DecodeArgs& d, int p0, int p1,
                                 cudaStream_t st) {
#define MP_CALL(NL, NO, GEN) \
  launch_split<NL, NO, GEN, false, true>(d, 1, p0, p1, st)
  MP_FOR_FORMAT(d.m.n_limbs, d.m.max_order, MP_CALL);
#undef MP_CALL
}

cudaError_t proj_decode_for_format(const ProjArgs& p, int n_out, int p0,
                                   int p1, cudaStream_t st) {
#define MP_CALL(NL, NO, GEN) \
  launch_proj_decode<NL, NO, GEN>(p, n_out, p0, p1, st)
  MP_FOR_FORMAT(p.n_limbs, p.max_order, MP_CALL);
#undef MP_CALL
}

cudaError_t mixed_for_format(const MixedDecodeArgs& d, int p0, int p1,
                             cudaStream_t st) {
#define MP_CALL(NL, NO, GEN) launch_mixed_split<NL, NO, GEN>(d, p0, p1, st)
  MP_FOR_FORMAT(d.d.m.n_limbs, d.d.m.max_order, MP_CALL);
#undef MP_CALL
}

// the registers a thread of a split kernel: kind 0 the fused matmul's, 1
// its partials', 2 the pre-limbed matmul's, 3 the projection's (nout
// weights a block), 4 the mixed-lane matmul's
template <int NL, int NO, bool GEN>
int split_regs(int kind, int nout) {
  switch (kind) {
    case 0:
      return kernel_regs<
          matmul_split_kernel<NL, NO, GEN, 1, Epi::COMBINE, false, false>>();
    case 1:
      return kernel_regs<
          matmul_split_kernel<NL, NO, GEN, 1, Epi::PARTS, false, false>>();
    case 2:
      return kernel_regs<
          matmul_split_kernel<NL, NO, GEN, 1, Epi::COMBINE, true, false>>();
    case 3:
      if (nout == 2)
        return kernel_regs<
            matmul_split_kernel<NL, NO, GEN, 2, Epi::PROJ, false, false>>();
      return kernel_regs<
          matmul_split_kernel<NL, NO, GEN, 1, Epi::PROJ, false, false>>();
    case 4:
      return kernel_regs<
          matmul_split_kernel<NL, NO, GEN, 1, Epi::COMBINE, true, true>>();
  }
  return 0;
}

}  // namespace

extern "C" {

// C[z] (M, N) = A[z] (M, K) @ B[z] (K, N) at (n_limbs, max_order): the fused
// matmul's decode tile (M <= DEC_M, any strides) or its TMA prefill tile
// (M > DEC_M, operands a tensor map can read); parts: the partials
// epilogue, C[o] at c + o * c_so for o <= max_order, uncombined.  Strides in
// elements; z = z0 * nb1 + z1 over nb0 * nb1 batches.  The autotuner's
// launch parameters, 0 for the plan's: at M <= DEC_M p0 = the k per ring
// stage (a multiple of KC within the ring), p1 = the cluster size (1..8);
// at larger M both 0 (the prefill tile has none).  None changes a bit.
// The partials epilogue at M > DEC_M takes one limb only.  Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for operands or parameters the tile cannot take).
// Allocates nothing and does not synchronise.
int mp_hopper_matmul_launch(const void* a, int64_t a_sb0, int64_t a_sb1,
                            int64_t a_sr, int64_t a_sc, const void* b,
                            int64_t b_sb0, int64_t b_sb1, int64_t b_sr,
                            int64_t b_sc, void* c, int64_t c_sb0,
                            int64_t c_sb1, int64_t c_sr, int64_t c_sc,
                            int64_t c_so, int64_t parts, int64_t nb0,
                            int64_t nb1, int64_t M, int64_t N, int64_t K,
                            int64_t n_limbs, int64_t max_order, int64_t p0,
                            int64_t p1, void* stream) {
  if (!format_ok(n_limbs, max_order) || nb0 < 1 || nb1 < 1 ||
      nb0 * nb1 > 65535 || p0 < 0 || p1 < 0 || p0 > 4096 || p1 > 64)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  MatmulArgs p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<float*>(c), a_sb0, a_sb1, a_sr, a_sc, b_sb0, b_sb1,
               b_sr, b_sc, c_sb0, c_sb1, c_sr, c_sc, nb1, M, N, K,
               (int)n_limbs, (int)max_order, c_so};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(parts ? hopper_for_format<true>(p, nb0, (int)p0, (int)p1, st)
                     : hopper_for_format<false>(p, nb0, (int)p0, (int)p1, st));
}

// out = epilogue(A @ B_t for t < n_out) at (n_limbs, max_order) on the
// projection's TMA prefill tile (M > DEC_M; A (M, K) and each B_t (K, N)
// with column stride 1 and row strides a map reads): the arguments of
// mp_fused_proj_launch (csrc/mp_matmul.cu) without its launch parameters
// (this tile has none).  Returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue for operands the tile cannot take).
// Allocates nothing and does not synchronise.
int mp_hopper_proj_launch(const void* a, int64_t a_sr, const void* b0,
                          const void* b1, const void* b2, int64_t b_sr,
                          const void* bias0, const void* bias1,
                          const void* bias2, const void* res, int64_t res_sr,
                          void* out, int64_t n_out, int64_t gate, int64_t M,
                          int64_t N, int64_t K, int64_t n_limbs,
                          int64_t max_order, void* stream) {
  if (!format_ok(n_limbs, max_order) || n_out < 1 || n_out > MAX_OUT ||
      (gate && n_out != 2) || (res != nullptr && !gate && n_out != 1) ||
      M <= DEC_M)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  ProjArgs p{};
  p.a = static_cast<const float*>(a);
  const void* bs[MAX_OUT] = {b0, b1, b2};
  const void* biases[MAX_OUT] = {bias0, bias1, bias2};
  for (int t = 0; t < MAX_OUT; ++t) {
    p.b[t] = static_cast<const float*>(bs[t]);
    p.bias[t] = static_cast<const float*>(biases[t]);
  }
  p.res = static_cast<const float*>(res);
  p.out = static_cast<float*>(out);
  p.a_sr = a_sr;
  p.b_sr = b_sr;
  p.res_sr = res_sr;
  p.M = M;
  p.N = N;
  p.K = K;
  p.n_limbs = (int)n_limbs;
  p.max_order = (int)max_order;
  p.gate = (int)gate;
  return (int)proj_for_format(p, (int)n_out, static_cast<cudaStream_t>(stream));
}

// C (M, N) = A (M, K) @ B at (n_limbs, max_order), B given as n_stored bf16
// limb planes (the arguments of mp_prelimbed_matmul_launch), on the split
// decode tile (M <= DEC_M): its stored planes fed by TMA where a map reads
// them.  p0, p1: the k per ring stage and the cluster size (0: the plan's,
// mp_split_plan with pl); none changes a bit.  Returns the CUDA error of
// the launch (0 on success).  Allocates nothing and does not synchronise.
int mp_hopper_prelimbed_launch(const void* a, int64_t a_sr, const void* b,
                               int64_t b_plane, int64_t b_sr,
                               int64_t n_stored, void* c, int64_t c_sr,
                               int64_t M, int64_t N, int64_t K,
                               int64_t n_limbs, int64_t max_order, int64_t p0,
                               int64_t p1, void* stream) {
  if (!format_ok(n_limbs, max_order) || n_stored < 1 || M > DEC_M ||
      p0 < 0 || p1 < 0 || p0 > 4096 || p1 > 64)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  DecodeArgs d{};
  d.m.a = static_cast<const float*>(a);
  d.m.c = static_cast<float*>(c);
  d.m.a_sr = a_sr;
  d.m.a_sc = 1;
  d.m.c_sr = c_sr;
  d.m.c_sc = 1;
  d.m.nb1 = 1;
  d.m.M = M;
  d.m.N = N;
  d.m.K = K;
  d.m.n_limbs = (int)n_limbs;
  d.m.max_order = (int)max_order;
  d.bp = Planes{static_cast<const __nv_bfloat16*>(b), b_plane, b_sr,
                (int)n_stored};
  return (int)prelimbed_for_format(d, (int)p0, (int)p1,
                                   static_cast<cudaStream_t>(stream));
}

// The projection at M <= DEC_M (the arguments of mp_hopper_proj_launch)
// on the split decode tile: gated, both weights a block; else one a block,
// the grid walking the weights.  p0, p1: the k per ring stage and the
// cluster size (0: the plan's, mp_split_plan with nout); none changes a
// bit.  Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for operands or parameters the tile cannot take).
// Allocates nothing and does not synchronise.
int mp_hopper_proj_decode_launch(const void* a, int64_t a_sr, const void* b0,
                                 const void* b1, const void* b2, int64_t b_sr,
                                 const void* bias0, const void* bias1,
                                 const void* bias2, const void* res,
                                 int64_t res_sr, void* out, int64_t n_out,
                                 int64_t gate, int64_t M, int64_t N, int64_t K,
                                 int64_t n_limbs, int64_t max_order,
                                 int64_t p0, int64_t p1, void* stream) {
  if (!format_ok(n_limbs, max_order) || n_out < 1 || n_out > MAX_OUT ||
      (gate && n_out != 2) || (res != nullptr && !gate && n_out != 1) ||
      M > DEC_M || p0 < 0 || p1 < 0 || p0 > 4096 || p1 > 64)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  ProjArgs p{};
  p.a = static_cast<const float*>(a);
  const void* bs[MAX_OUT] = {b0, b1, b2};
  const void* biases[MAX_OUT] = {bias0, bias1, bias2};
  for (int t = 0; t < MAX_OUT; ++t) {
    p.b[t] = static_cast<const float*>(bs[t]);
    p.bias[t] = static_cast<const float*>(biases[t]);
  }
  p.res = static_cast<const float*>(res);
  p.out = static_cast<float*>(out);
  p.a_sr = a_sr;
  p.b_sr = b_sr;
  p.res_sr = res_sr;
  p.M = M;
  p.N = N;
  p.K = K;
  p.n_limbs = (int)n_limbs;
  p.max_order = (int)max_order;
  p.gate = (int)gate;
  return (int)proj_decode_for_format(p, (int)n_out, (int)p0, (int)p1,
                                     static_cast<cudaStream_t>(stream));
}

// C (M, N) = A (M, K) @ B with row m at its own lane format (the arguments
// of mp_mixed_prelimbed_matmul_launch in mp_matmul.cu) on the split decode
// tile (M <= DEC_M): the envelope's stored planes fed by TMA where a map
// reads them.  p0, p1: the k per ring stage and the cluster size (0: the
// plan's); none changes a bit.  Returns the CUDA error of the launch (0 on
// success).  Allocates nothing and does not synchronise.
int mp_hopper_mixed_prelimbed_launch(const void* a, int64_t a_sr,
                                     const void* b, int64_t b_plane,
                                     int64_t b_sr, int64_t n_stored,
                                     const void* lane_n, const void* lane_ord,
                                     void* c, int64_t c_sr, int64_t M,
                                     int64_t N, int64_t K, int64_t n_limbs,
                                     int64_t max_order, int64_t p0, int64_t p1,
                                     void* stream) {
  if (!format_ok(n_limbs, max_order) || n_stored < 1 || lane_n == nullptr ||
      lane_ord == nullptr || M > DEC_M || p0 < 0 || p1 < 0 || p0 > 4096 ||
      p1 > 64)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  MixedDecodeArgs d{};
  d.d.m.a = static_cast<const float*>(a);
  d.d.m.c = static_cast<float*>(c);
  d.d.m.a_sr = a_sr;
  d.d.m.a_sc = 1;
  d.d.m.c_sr = c_sr;
  d.d.m.c_sc = 1;
  d.d.m.nb1 = 1;
  d.d.m.M = M;
  d.d.m.N = N;
  d.d.m.K = K;
  d.d.m.n_limbs = (int)n_limbs;
  d.d.m.max_order = (int)max_order;
  d.d.bp = Planes{static_cast<const __nv_bfloat16*>(b), b_plane, b_sr,
                  (int)n_stored};
  d.lane_n = static_cast<const int32_t*>(lane_n);
  d.lane_ord = static_cast<const int32_t*>(lane_ord);
  return (int)mixed_for_format(d, (int)p0, (int)p1,
                               static_cast<cudaStream_t>(stream));
}

// C (M, N) = A @ B at (n_limbs, max_order), both given as stored bf16 limb
// planes (the arguments of mp_both_prelimbed_matmul_launch in mp_matmul.cu)
// on the TMA + wgmma tile, at a built-in format whose planes a tensor map
// reads (rows and plane strides a multiple of 16 bytes, 16-byte aligned
// bases) and K >= 1.  Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for a run-time format or a layout the tile does
// not take).  Allocates nothing and does not synchronise.
int mp_hopper_both_prelimbed_launch(const void* a, int64_t a_plane,
                                    int64_t a_sr, int64_t na_stored,
                                    const void* b, int64_t b_plane,
                                    int64_t b_sr, int64_t nb_stored, void* c,
                                    int64_t c_sr, int64_t M, int64_t N,
                                    int64_t K, int64_t n_limbs,
                                    int64_t max_order, void* stream) {
  if (!format_ok(n_limbs, max_order) || !builtin_format(n_limbs, max_order) ||
      na_stored < 1 || nb_stored < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const Planes ap{static_cast<const __nv_bfloat16*>(a), a_plane, a_sr,
                  (int)(na_stored < GEN_NL ? na_stored : GEN_NL)};
  const Planes bp{static_cast<const __nv_bfloat16*>(b), b_plane, b_sr,
                  (int)(nb_stored < GEN_NL ? nb_stored : GEN_NL)};
  float* const cc = static_cast<float*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_limbs) {
    case 1: return (int)launch_both<1, 1>(ap, bp, cc, c_sr, M, N, K, st);
    case 2: return (int)launch_both<2, 2>(ap, bp, cc, c_sr, M, N, K, st);
    case 3: return (int)launch_both<3, 3>(ap, bp, cc, c_sr, M, N, K, st);
    case 5: return (int)launch_both<5, 5>(ap, bp, cc, c_sr, M, N, K, st);
    default: return (int)launch_both<7, 7>(ap, bp, cc, c_sr, M, N, K, st);
  }
}

// The both-prelimbed tile's pins at a built-in format: out = {BM, BN,
// stages, dynamic shared memory, warpgroup 0's orders and warpgroup 1's as
// bit masks (the row split: every order in each)}.  Returns 0, or -1 where
// the format has no tile.
int mp_both_tile(int64_t n_limbs, int64_t max_order, int64_t* out) {
  if (!builtin_format(n_limbs, max_order)) return -1;
  const int nl = (int)n_limbs, no = (int)max_order + 1;
  const bool os = bp_osplit(no);
  int64_t masks[2] = {0, 0};
  for (int w = 0; w < 2; ++w)
    if (os)
      for (int q = 0; q < bp_count(no, w); ++q)
        masks[w] |= (int64_t)1 << bp_order(no, w, q);
    else
      masks[w] = ((int64_t)1 << no) - 1;
  const int64_t v[6] = {bp_bm(no), bp_bn(no), bp_stages(nl, no),
                        bp_smem(nl, no), masks[0], masks[1]};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// The prefill tile's columns for a format (hp_bn) at nout weights a block
// (the projection's gated block holds 2) and one block's dynamic shared
// memory (at its hp_rs f32 stages).
int mp_tma_tile_n(int64_t n_limbs, int64_t max_order, int64_t nout) {
  return hp_bn((int)nout * (builtin_format(n_limbs, max_order)
                                ? (int)max_order + 1
                                : GEN_NO));
}

int64_t mp_tma_smem_bytes(int64_t n_limbs, int64_t max_order, int64_t nout) {
  const int nl = builtin_format(n_limbs, max_order) ? (int)n_limbs : GEN_NL;
  const int bn = mp_tma_tile_n(n_limbs, max_order, nout);
  return hp_smem(nl, bn, hp_rs(nl, bn, (int)nout), (int)nout);
}

// The decode plan's cluster size for slabs column slabs (times grid.y and
// the batch), K and M rows at a format, nout weights a block and regs
// registers a thread, on a card of sms SMs with sm_smem bytes of shared
// memory an SM and optin a block (pl: B as stored planes, the pre-limbed
// and mixed-lane matmuls'); its k per stage for a rank's K range kr of cpr
// chunks; the split tile's shared memory; and the registers of a split
// kernel (mp_split_regs: kind 0 fused, 1 partials, 2 pre-limbed, 3
// projection, 4 mixed-lane; needs the card).
int mp_split_plan(int64_t pl, int64_t slabs, int64_t K, int64_t n_limbs,
                  int64_t max_order, int64_t M, int64_t nout, int64_t regs,
                  int64_t sms, int64_t sm_smem, int64_t optin, int* dk) {
  const bool b = builtin_format(n_limbs, max_order);
  return split_plan(pl != 0, slabs, K, (int)n_limbs,
                    b ? (int)max_order + 1 : GEN_NO, (int)M, (int)nout,
                    (int)regs,
                    b && n_limbs <= 3 ? DecRing<1>::K : DecRing<GEN_NL>::K,
                    (int)sms, sm_smem, optin, dk);
}

int mp_split_dk(int64_t pl, int64_t n_limbs, int64_t max_order, int64_t M,
                int64_t kr, int64_t cpr, int64_t nout, int64_t optin) {
  const bool b = builtin_format(n_limbs, max_order);
  return split_dk(pl != 0, (int)n_limbs, b ? (int)max_order + 1 : GEN_NO,
                  (int)M, kr, (int)cpr, (int)nout,
                  b && n_limbs <= 3 ? DecRing<1>::K : DecRing<GEN_NL>::K,
                  optin);
}

int mp_split_regs(int64_t kind, int64_t nout, int64_t n_limbs,
                  int64_t max_order) {
#define MP_CALL(NL, NO, GEN) split_regs<NL, NO, GEN>((int)kind, (int)nout)
  MP_FOR_FORMAT(n_limbs, max_order, MP_CALL);
#undef MP_CALL
}

int mp_split_norm(int64_t K, int64_t s) {
  return split_norm((K + KC - 1) / KC, (int)s);
}

int64_t mp_split_smem_bytes(int64_t pl, int64_t n_limbs, int64_t max_order,
                            int64_t M, int64_t kr, int64_t dk, int64_t cpr,
                            int64_t nout) {
  const bool b = builtin_format(n_limbs, max_order);
  return split_smem_bytes(pl != 0, (int)n_limbs,
                          b ? (int)max_order + 1 : GEN_NO, (int)M, kr,
                          (int)dk, (int)cpr, (int)nout);
}

}  // extern "C"
