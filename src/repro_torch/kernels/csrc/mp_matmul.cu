// Multi-precision limb matmul kernels for Hopper (sm_90a), plain C interface.
//
// Ports of the Pallas TPU kernels in src/repro/kernels/mp_matmul.py:
//
//   fused_matmul_kernel  replaces _fused_kernel        (one output, batched,
//                                                      arbitrary strides)
//   fused_proj_kernel    replaces _fused_multi_kernel  (one A operand shared
//                                                      by n_out B operands,
//                                                      bias / swiglu / residual
//                                                      epilogue)
//   prelimbed_matmul_kernel  replaces _prelimbed_kernel  (B as stored bf16
//                                                      limb planes: serving
//                                                      decode)
//   decompose_kernel     replaces _decompose_kernel    (f32 -> bf16 limb
//                                                      planes, once per
//                                                      policy)
//   mixed_prelimbed_matmul_kernel  replaces _mixed_prelimbed_kernel  (the
//                                                      pre-limbed kernel at a
//                                                      batch's envelope
//                                                      depth, each row at its
//                                                      own lane format:
//                                                      mixed-format decode)
//   both_prelimbed_matmul_kernel  replaces _both_prelimbed_kernel  (A and B
//                                                      both as stored bf16
//                                                      limb planes: two-float
//                                                      DD operands, modes 5
//                                                      and 6)
//
// What they compute: C = sum over the format's kept limb pairs (i, j) of
// A_i * B_j, where X_i is the i-th bf16 limb of the f32 operand (the
// round-to-nearest cascade l0 = bf16(x), l1 = bf16(x - l0), ...).  One f32
// accumulator per limb-product order o = i + j is carried across the whole K
// loop, and the orders are joined at the end by the Neumaier-compensated
// combine of _combine_orders: start from the highest order, walk down, and
// take the |s| >= |t| branch of the compensation.
//
// What bounds them on this card, and what the design does about it: every
// kernel multiplies bf16-rounded limbs with f32 FMAs on the CUDA cores (a
// bf16 x bf16 product is exact in f32, so each FMA adds the exact product),
// and each output element is one serial fmaf chain over k ascending, one
// accumulator per order: that order is what keeps pre-limbed == fused,
// mixed rows == homogeneous rows and scheduled == solo bit for bit, so no
// kernel splits K or sums through a tensor-core MMA.
//
// The prefill shapes (M = 2048) are bound by the limb products: a 64 x 64
// output tile per 256-thread block (mainloop), every operand element read
// from device memory once per tile, limbed once as it is loaded, and kept in
// shared memory as bf16 limb planes that all threads of the block reuse; the
// multi-output kernel limbs its A tile once for all n_out weights.
//
// The decode shapes (M <= 16 rows) of the fused, pre-limbed, mixed-lane and
// projection kernels are bound by the fmaf chain (K times the deepest
// order's products, ~4 cycles each: ~7 us at K = 3072 for M8) and by the
// bytes of the weights (the planes the format reads, or the f32 weights).
// They take the decode tile (decode_tile): rows sized to M, 16 columns per
// block so that N = 768 runs 48 blocks (the projection: 48 per weight), and
// B streamed through a cp.async ring so that the loads of the next stages
// overlap this stage's FMAs.  Ragged edges are masked in the loads and
// stores; nothing is padded in device memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (no --use_fast_math).  --fmad=false keeps every a*b+c outside the explicit
// fmaf() calls of the main loops rounded twice, as the PyTorch plain versions
// round it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;            // threads along N
constexpr int TY = 16;            // threads along M
constexpr int NT = TX * TY;       // threads per block
constexpr int BK = 16;            // K depth of one shared-memory tile
constexpr int MAX_OUT = 3;        // weights per fused projection launch
constexpr int PAD_N = 1;          // lane of a row past M (lanes.PAD_LANE)
constexpr int PAD_ORD = 0;

// Largest limb count and order count of the generic (any registered format)
// instantiation; the built-in formats get their own instantiations.
constexpr int GEN_NL = 8;
constexpr int GEN_NO = 2 * GEN_NL - 1;

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The on-the-fly limb cascade of _extract_limbs, in registers.
template <int NL>
__device__ __forceinline__ void extract_limbs(float x, __nv_bfloat16 (&l)[NL]) {
  float r = x;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    l[i] = __float2bfloat16_rn(r);
    r = r - bf(l[i]);
  }
}

// Neumaier-compensated combine of one output's per-order accumulators,
// highest order first (_combine_orders).  ``mo`` is the format's max_order.
template <int NO>
__device__ __forceinline__ float combine_orders(const float (&acc)[NO], int mo) {
  if (mo == 0) return acc[0];
  float s = 0.f, c = 0.f;
  bool started = false;
#pragma unroll
  for (int o = NO - 1; o >= 0; --o) {
    if (o > mo) continue;
    const float t = acc[o];
    if (!started) {
      s = t;
      started = true;
    } else {
      const float tmp = s + t;
      c = c + ((fabsf(s) >= fabsf(t)) ? ((s - tmp) + t) : ((t - tmp) + s));
      s = tmp;
    }
  }
  return s + c;
}

// Stored bf16 limb planes of a pre-limbed operand (the serving path's
// PrelimbedWeight, or a DD operand's limbs): plane j of element (r, c) at
// p[j * plane + r * sr + c].  Planes j >= n_stored count as zero and are
// never read.
struct Planes {
  const __nv_bfloat16* p;
  int64_t plane, sr;
  int n_stored;
};

// The shared main loop: accumulates, for NOUT weights at once, the kept limb
// products of the (BM x BN) output tile at (m0, n0) into per-order
// accumulators acc[t][o][r][c].  Thread (tx, ty) owns rows m0 + ty + r*TY and
// columns n0 + tx + c*TX, so global stores and shared-memory reads of
// neighbouring threads touch neighbouring addresses.  PL: B comes as stored
// limb planes (``bp``, NOUT == 1) instead of f32 values limbed here; the
// products and the order of every add are the same either way, so a
// pre-limbed run is bitwise the f32 run on the weight the planes came from.
// LN: each row m runs at its own lane (ln[m] limbs, order cut lo[m]) at or
// below the (n_limbs, max_order) envelope; a product the row's lane leaves
// out skips its FMA, so the row's accumulators see exactly the FMAs, in the
// same order, as a homogeneous run at the lane's format.  PLA: A comes as
// stored limb planes too (``ap``); on planes cut from f32 operands the
// run is bitwise the f32 run, as for PL.
template <int NL, int NO, int NOUT, int RM, int RN, bool GEN, bool PL = false,
          bool LN = false, bool PLA = false>
__device__ __forceinline__ void mainloop(
    const float* __restrict__ A, int64_t a_sr, int64_t a_sc,
    const float* const* B, int64_t b_sr, int64_t b_sc,
    int64_t M, int64_t N, int64_t K, int64_t m0, int64_t n0,
    int n_limbs, int max_order, float (&acc)[NOUT][NO][RM][RN],
    Planes bp = Planes{}, const int32_t* __restrict__ ln = nullptr,
    const int32_t* __restrict__ lo = nullptr, Planes ap = Planes{}) {
  constexpr int BM = TY * RM;
  constexpr int BN = TX * RN;
  __shared__ __nv_bfloat16 As[NL][BK][BM];
  __shared__ __nv_bfloat16 Bs[NOUT][NL][BK][BN];

  // built-in instantiations fold these to constants
  const int nl = GEN ? n_limbs : NL;
  const int mo = GEN ? max_order : NO - 1;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

#pragma unroll
  for (int t = 0; t < NOUT; ++t)
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[t][o][r][c] = 0.f;

  // the rows' lanes, in registers for the whole K loop (LN only)
  int rn[RM], ro[RM];
  if constexpr (LN) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int64_t gm = m0 + ty + r * TY;
      rn[r] = gm < M ? ln[gm] : PAD_N;
      ro[r] = gm < M ? lo[gm] : PAD_ORD;
    }
  }

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    if constexpr (PLA) {
      // A's stored planes, as PL reads B's: only planes below both the
      // stored count and the format's limb count leave device memory
      const int nst = ap.n_stored < nl ? ap.n_stored : nl;
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      for (int idx = tid; idx < BM * BK; idx += NT) {
        const int mm = idx / BK;
        const int kk = idx % BK;
        const int64_t gm = m0 + mm;
        const int64_t gk = k0 + kk;
        const bool in = gm < M && gk < K;
        const __nv_bfloat16* src = ap.p + gm * ap.sr + gk;
#pragma unroll
        for (int i = 0; i < NL; ++i)
          As[i][kk][mm] = (in && i < nst) ? src[i * ap.plane] : zero;
      }
    } else {
      // A tile: read once, limbed once, shared by every output and thread
      for (int idx = tid; idx < BM * BK; idx += NT) {
        const int mm = idx / BK;
        const int kk = idx % BK;
        const int64_t gm = m0 + mm;
        const int64_t gk = k0 + kk;
        const float x = (gm < M && gk < K) ? A[gm * a_sr + gk * a_sc] : 0.f;
        __nv_bfloat16 l[NL];
        extract_limbs<NL>(x, l);
#pragma unroll
        for (int i = 0; i < NL; ++i) As[i][kk][mm] = l[i];
      }
    }
    if constexpr (PL) {
      // stored planes, read as they are: only planes below both the stored
      // count and the format's limb count leave device memory
      const int nst = bp.n_stored < nl ? bp.n_stored : nl;
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      for (int idx = tid; idx < BK * BN; idx += NT) {
        const int kk = idx / BN;
        const int nn = idx % BN;
        const int64_t gk = k0 + kk;
        const int64_t gn = n0 + nn;
        const bool in = gk < K && gn < N;
        const __nv_bfloat16* src = bp.p + gk * bp.sr + gn;
#pragma unroll
        for (int j = 0; j < NL; ++j)
          Bs[0][j][kk][nn] = (in && j < nst) ? src[j * bp.plane] : zero;
      }
    } else {
#pragma unroll
      for (int t = 0; t < NOUT; ++t) {
        for (int idx = tid; idx < BK * BN; idx += NT) {
          const int kk = idx / BN;
          const int nn = idx % BN;
          const int64_t gk = k0 + kk;
          const int64_t gn = n0 + nn;
          const float x =
              (gk < K && gn < N) ? B[t][gk * b_sr + gn * b_sc] : 0.f;
          __nv_bfloat16 l[NL];
          extract_limbs<NL>(x, l);
#pragma unroll
          for (int j = 0; j < NL; ++j) Bs[t][j][kk][nn] = l[j];
        }
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float a[RM][NL];
      float b[NOUT][RN][NL];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int i = 0; i < NL; ++i) a[r][i] = bf(As[i][kk][ty + r * TY]);
#pragma unroll
      for (int t = 0; t < NOUT; ++t)
#pragma unroll
        for (int c = 0; c < RN; ++c)
#pragma unroll
          for (int j = 0; j < NL; ++j) b[t][c][j] = bf(Bs[t][j][kk][tx + c * TX]);
#pragma unroll
      for (int i = 0; i < NL; ++i) {
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          if (i + j >= NO) continue;  // compile-time: no such accumulator
          if (i >= nl || j >= nl || i + j > mo) continue;  // order cut
#pragma unroll
          for (int t = 0; t < NOUT; ++t)
#pragma unroll
            for (int r = 0; r < RM; ++r) {
              if constexpr (LN) {
                // the row's own order cut (ref.lane_keep)
                if (i >= rn[r] || j >= rn[r] || i + j > ro[r]) continue;
              }
#pragma unroll
              for (int c = 0; c < RN; ++c)
                acc[t][i + j][r][c] =
                    fmaf(a[r][i], b[t][c][j], acc[t][i + j][r][c]);
            }
        }
      }
    }
    __syncthreads();
  }
}

struct MatmulArgs {
  const float* a;
  const float* b;
  float* c;
  int64_t a_sb0, a_sb1, a_sr, a_sc;
  int64_t b_sb0, b_sb1, b_sr, b_sc;
  int64_t c_sb0, c_sb1, c_sr, c_sc;
  int64_t nb1;  // size of the second batch dim (grid.z = nb0 * nb1)
  int64_t M, N, K;
  int n_limbs, max_order;
};

// One (BM x BN) tile at (blockIdx.y, blockIdx.x) of C = A @ B at the format,
// B as f32 values or (PL) as stored limb planes, rows at their own lanes
// (LN), A as stored limb planes (PLA): the body of fused_matmul_kernel,
// prelimbed_matmul_kernel, mixed_prelimbed_matmul_kernel and
// both_prelimbed_matmul_kernel, so the four share every add of every output
// element.
template <int NL, int NO, int RM, int RN, bool GEN, bool PL, bool LN = false,
          bool PLA = false>
__device__ __forceinline__ void matmul_tile(
    const float* A, int64_t a_sr, int64_t a_sc, const float* B, int64_t b_sr,
    int64_t b_sc, Planes bp, float* C, int64_t c_sr, int64_t c_sc, int64_t M,
    int64_t N, int64_t K, int n_limbs, int max_order,
    const int32_t* ln = nullptr, const int32_t* lo = nullptr,
    Planes ap = Planes{}) {
  constexpr int BM = TY * RM;
  constexpr int BN = TX * RN;
  const float* const Bt[1] = {B};
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t n0 = (int64_t)blockIdx.x * BN;

  float acc[1][NO][RM][RN];
  mainloop<NL, NO, 1, RM, RN, GEN, PL, LN, PLA>(A, a_sr, a_sc, Bt, b_sr, b_sc,
                                                M, N, K, m0, n0, n_limbs,
                                                max_order, acc, bp, ln, lo,
                                                ap);
  const int mo = GEN ? max_order : NO - 1;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int64_t gm = m0 + ty + r * TY;
      const int64_t gn = n0 + tx + c * TX;
      if (gm >= M || gn >= N) continue;
      float per_order[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) per_order[o] = acc[0][o][r][c];
      // a lane row joins its own orders, from its own highest one down
      const int mo_r = LN ? lo[gm] : mo;
      C[gm * c_sr + gn * c_sc] = combine_orders<NO>(per_order, mo_r);
    }
  }
}

// ---------------------------------------------------------------------------
// The decode tile: the body of fused_matmul_kernel, prelimbed_matmul_kernel,
// mixed_prelimbed_matmul_kernel and fused_proj_kernel when M <= DEC_M (a
// decode micro-batch of 1..16 rows, or one row per batch entry of decode
// attention's QK and PV).
//
// Invariant: every output element gets exactly the fmaf()s mainloop gives it,
// in the same order, so a row has the same bits whichever tile ran it (and
// pre-limbed == fused, mixed rows == homogeneous rows and scheduled == solo
// keep holding).  For k ascending over 0..K-1, then i, then j over the kept
// pairs: acc[i + j] = fmaf(a_i, b_j, acc[i + j]), planes at or past the
// stored count read as +0.0 as mainloop reads them, then combine_orders with
// the same mo.  mainloop runs K up to a multiple of BK on zero-filled tiles:
// fmaf(+0, +0, acc) is the identity except that it turns an accumulator of
// -0.0 (a sum that underflowed from below) into +0.0, and is idempotent, so
// the tile adds one such step at the end when K % BK != 0.  LN: a row at its
// own lane skips the products its lane leaves out, in the step and in the
// zero step, and joins its orders from its own cut down, as mainloop and
// matmul_tile do.  NOUT weights: each output of each weight is a chain of its
// own, in the same order as mainloop's per-weight accumulators.  No split
// over K, no tensor-core MMA: either would reorder the adds.
//
// Design: the block owns DEC_N columns and all M rows, one output element per
// compute thread (M * DEC_N of them), so a thread carries only its NOUT * NO
// accumulators, and N = 768 runs 48 blocks.  Two or four producer warps
// (warp specialisation) stream A and the NOUT Bs through a ring of
// DecRing::S stages of up to DecRing::K k each in dynamic shared memory, by
// cp.async (16-byte cp.async.cg where the rows are contiguous and 16-byte
// aligned, else element by element), and limb stage s + 1 (A's rows, once for
// every weight; the f32 Bs too) into bf16 planes, once per block, while the
// compute warps run stage s from the other of two plane buffers: one block
// barrier per stage.  A compute thread reads A's planes by 16-byte broadcast
// reads, 8 k at a time, its B columns 8 k at a time, and (where the
// registers allow) keeps the next 8 k's reads in flight while this 8's FMAs
// run, so the fmaf chain, not shared-memory latency, sets the pace.
constexpr int DEC_M = 16;   // most rows of the decode tile
constexpr int DEC_N = 16;   // columns of one block

// ring shape per limb count: deeper formats do more FMAs per byte
template <int NL>
struct DecRing {
  static constexpr int K = NL <= 3 ? 256 : 128;  // most k of one stage
  static constexpr int S = 3;                    // stages
  // producer warps: the fused kernels limb their B stages as well
  static constexpr int P(bool pl) { return pl ? 2 : 4; }
};

// threads that own outputs: M rows of DEC_N, whole warps
__host__ __device__ inline int dec_compute_threads(int M) {
  return (M * DEC_N + 31) / 32 * 32;
}

// dynamic shared memory of the decode tile: the B ring (bf16 planes, or f32
// for each of nout weights), the A ring (f32), A's limb planes and (fused)
// the Bs' limb planes, two buffers each; every region a multiple of 16 bytes
// (dk is a multiple of 8)
__host__ __device__ inline int64_t dec_ring_b_bytes(bool pl, int nl, int dk,
                                                    int slots, int nout) {
  return pl ? (int64_t)slots * nl * dk * DEC_N * 2
            : (int64_t)nout * slots * dk * DEC_N * 4;
}

__host__ __device__ inline int64_t dec_smem_bytes(bool pl, int nl, int M,
                                                  int dk, int slots,
                                                  int nout) {
  return dec_ring_b_bytes(pl, nl, dk, slots, nout) +
         (int64_t)slots * M * dk * 4 + 2 * (int64_t)nl * M * dk * 2 +
         (pl ? 0 : 2 * (int64_t)nout * nl * dk * DEC_N * 2);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous global -> shared copies; a false predicate fills zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

// 16-byte copy of which the first ``bytes`` come from src, the rest zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// element u (0..7) of eight packed bf16 values, as f32
__device__ __forceinline__ float bf_at(const uint4& v, int u) {
  const uint32_t w = u < 2 ? v.x : u < 4 ? v.y : u < 6 ? v.z : v.w;
  return __uint_as_float((u & 1) ? (w & 0xffff0000u) : (w << 16));
}

// limbs of 4 f32 values (16-byte aligned) into nl bf16 planes (8-byte
// aligned, plane stride ``ps`` elements): extract_limbs on each value
template <int NL>
__device__ __forceinline__ void limb4(const float* src, __nv_bfloat16* dst,
                                      int ps, int nl) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  __nv_bfloat16 l[4][NL];
  extract_limbs<NL>(x.x, l[0]);
  extract_limbs<NL>(x.y, l[1]);
  extract_limbs<NL>(x.z, l[2]);
  extract_limbs<NL>(x.w, l[3]);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    if (i >= nl) continue;
    uint2 w;
    w.x = (uint32_t)__bfloat16_as_ushort(l[0][i]) |
          ((uint32_t)__bfloat16_as_ushort(l[1][i]) << 16);
    w.y = (uint32_t)__bfloat16_as_ushort(l[2][i]) |
          ((uint32_t)__bfloat16_as_ushort(l[3][i]) << 16);
    *reinterpret_cast<uint2*>(dst + i * ps) = w;
  }
}

// one k of mainloop's inner loop for one output element; LN: the row's own
// lane (rn limbs, order cut ro) cuts as well
template <int NL, int NO, bool LN = false>
__device__ __forceinline__ void fma_step(const float (&a)[NL],
                                         const float (&b)[NL],
                                         float (&acc)[NO], int nl, int mo,
                                         int rn = 0, int ro = 0) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      if (i + j >= NO) continue;
      if (i >= nl || j >= nl || i + j > mo) continue;
      if constexpr (LN) {
        if (i >= rn || j >= rn || i + j > ro) continue;
      }
      acc[i + j] = fmaf(a[i], b[j], acc[i + j]);
    }
  }
}

// dk: k per ring stage (a multiple of 8, at most DecRing<NL>::K); the
// dynamic shared memory holds dec_smem_bytes(PL, nl, M, dk, slots, NOUT)
// bytes, slots = min(DecRing<NL>::S, stages).  Warp roles: the first
// dec_compute_threads(M) threads own one output of each weight (row
// tid / DEC_N, column tid % DEC_N); the DecRing<NL>::P(PL) warps after them
// copy and limb.  B: NOUT f32 weights (PL: unused, NOUT == 1, the planes
// bp instead); LN: row r's lane is (ln[r], lo[r]).  The row's NOUT results
// go to store(r, column, y) after combine_orders.
template <int NL, int NO, bool GEN, bool PL, bool LN = false, int NOUT = 1,
          typename Store>
__device__ __forceinline__ void decode_tile(
    const float* __restrict__ A, int64_t a_sr, int64_t a_sc,
    const float* const (&B)[NOUT], int64_t b_sr, int64_t b_sc, Planes bp,
    int M, int64_t N, int64_t K, int n_limbs, int max_order, int dk,
    const int32_t* __restrict__ ln, const int32_t* __restrict__ lo,
    Store store) {
  static_assert(!PL || NOUT == 1, "stored planes come for one weight");
  constexpr int NS = DecRing<NL>::S;
  // 16-byte copies where rows are contiguous and every chunk is aligned
  bool b_al = true;
#pragma unroll
  for (int t = 0; t < NOUT; ++t) b_al = b_al && aligned16(B[t]);
  const bool vec_a = a_sc == 1 && a_sr % 4 == 0 && aligned16(A);
  const bool vec_b = PL ? bp.sr % 8 == 0 && bp.plane % 8 == 0 &&
                              N % 8 == 0 && aligned16(bp.p)
                        : b_sc == 1 && b_sr % 4 == 0 && N % 4 == 0 && b_al;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int nl = GEN ? n_limbs : NL;
  const int mo = GEN ? max_order : NO - 1;
  const int stages = dk > 0 ? (int)((K + dk - 1) / dk) : 0;
  const int slots = stages < NS ? stages : NS;
  const int plane = M * dk;  // elements of one A limb plane at one stage
  // regions of dec_smem: the B ring, the A ring, A's limb planes (two
  // buffers), the Bs' limb planes (fused, two buffers each)
  __nv_bfloat16* const Bp = reinterpret_cast<__nv_bfloat16*>(dec_smem);
  float* const Br = reinterpret_cast<float*>(dec_smem);
  float* const Ar = reinterpret_cast<float*>(
      dec_smem + dec_ring_b_bytes(PL, nl, dk, slots, NOUT));
  __nv_bfloat16* const As =
      reinterpret_cast<__nv_bfloat16*>(Ar + (int64_t)slots * plane);
  __nv_bfloat16* const Bl = As + 2 * nl * plane;
  auto bp_at = [&](int q, int j) { return (q * nl + j) * dk * DEC_N; };
  auto br_at = [&](int q, int t) { return (q * NOUT + t) * dk * DEC_N; };
  auto as_at = [&](int buf, int i) { return (buf * nl + i) * plane; };
  auto bl_at = [&](int buf, int t, int j) {
    return ((buf * NOUT + t) * nl + j) * dk * DEC_N;
  };

  const int tid = threadIdx.x;
  const int ct = dec_compute_threads(M);
  const bool producer = tid >= ct;
  const int pt = tid - ct;  // producer thread index
  const int np = (int)blockDim.x - ct;
  const int r = tid / DEC_N;
  const int c = tid % DEC_N;
  const int64_t n0 = (int64_t)blockIdx.x * DEC_N;
  const int nst = PL ? (bp.n_stored < nl ? bp.n_stored : nl) : nl;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  auto stage_k = [&](int s) {
    const int64_t left = K - (int64_t)s * dk;
    return left < dk ? (int)left : dk;
  };

  // producers: stage s of A and B into ring slot s % NS, only its valid k;
  // index maps by shifts and masks (DEC_N is 16), neighbouring threads on
  // neighbouring addresses where the layout allows
  auto load = [&](int s) {
    const int q = s % NS;
    const int64_t k0 = (int64_t)s * dk;
    const int kn = stage_k(s);
    if (vec_a) {
      // 16-byte chunks of 4 k; the last one of a row may be partial (the
      // rest zero-filled)
      const int ch = (kn + 3) >> 2;
      for (int m = 0; m < M; ++m)
        for (int e = pt; e < ch; e += np) {
          const int left = kn - 4 * e;
          cp_async16(Ar + q * plane + m * dk + 4 * e, A + m * a_sr + k0 + 4 * e,
                     left < 4 ? 4 * left : 16);
        }
    } else {
      for (int m = 0; m < M; ++m)
        for (int kk = pt; kk < kn; kk += np)
          cp_async4(Ar + q * plane + m * dk + kk,
                    A + m * a_sr + (k0 + kk) * a_sc, true);
    }
    if constexpr (PL) {
      for (int j = 0; j < nst; ++j) {
        const __nv_bfloat16* src = bp.p + j * bp.plane + k0 * bp.sr;
        __nv_bfloat16* dst = Bp + bp_at(q, j);
        if (vec_b) {
          // 16-byte chunks: two per plane row of 16 columns
          for (int e = pt; e < kn * 2; e += np) {
            const int kk = e >> 1;
            const int cc = (e & 1) * 8;
            const bool in = n0 + cc < N;
            cp_async16(dst + kk * DEC_N + cc,
                       in ? src + kk * bp.sr + n0 + cc : bp.p, in ? 16 : 0);
          }
        } else {
          for (int e = pt; e < kn * DEC_N; e += np) {
            const int64_t gn = n0 + (e & 15);
            dst[e] = gn < N ? src[(e >> 4) * bp.sr + gn] : zero;
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < NOUT; ++t) {
        const float* src = B[t] + k0 * b_sr;
        float* dst = Br + br_at(q, t);
        if (vec_b) {
          for (int e = pt; e < kn * 4; e += np) {
            const int kk = e >> 2;
            const int cc = (e & 3) * 4;
            const bool in = n0 + cc < N;
            cp_async16(dst + kk * DEC_N + cc,
                       in ? src + kk * b_sr + n0 + cc : B[t], in ? 16 : 0);
          }
        } else if (b_sr == 1) {
          // k contiguous in B (decode QK's transposed cache): walk k
          for (int nn = 0; nn < DEC_N; ++nn) {
            const bool in = n0 + nn < N;
            for (int kk = pt; kk < kn; kk += np)
              cp_async4(dst + kk * DEC_N + nn,
                        in ? src + kk + (n0 + nn) * b_sc : B[t], in);
          }
        } else {
          for (int e = pt; e < kn * DEC_N; e += np) {
            const int64_t gn = n0 + (e & 15);
            const bool in = gn < N;
            cp_async4(dst + e, in ? src + (e >> 4) * b_sr + gn * b_sc : B[t],
                      in);
          }
        }
      }
    }
  };
  // producers: wait for stage s, then limb it once for the block into
  // buffer s % 2
  auto limb = [&](int s) {
    cp_async_wait<NS - 2>();
    asm volatile("bar.sync 1, %0;\n" ::"r"(np));  // every copy has landed
    const int q = s % NS;
    const int kn = stage_k(s);
    const int buf = s & 1;
    // 4 k of one row (A) or 4 columns of one k (B) at a time; past a row's
    // kn the ring holds zeros or stale values, whose limbs no FMA reads
    const int ach = (kn + 3) >> 2;
    for (int e = pt; e < M * ach; e += np) {
      const int m = e / ach;
      const int kk = (e - m * ach) * 4;
      limb4<NL>(Ar + q * plane + m * dk + kk, As + as_at(buf, 0) + m * dk + kk,
                plane, nl);
    }
    if constexpr (!PL) {
#pragma unroll
      for (int t = 0; t < NOUT; ++t)
        for (int e = pt; e < kn * 4; e += np)
          limb4<NL>(Br + br_at(q, t) + 4 * e, Bl + bl_at(buf, t, 0) + 4 * e,
                    dk * DEC_N, nl);
    }
  };

  float acc[NOUT][NO];
#pragma unroll
  for (int t = 0; t < NOUT; ++t)
#pragma unroll
    for (int o = 0; o < NO; ++o) acc[t][o] = 0.f;
  // the row's lane, in registers for the whole K loop (LN only)
  int rn = 0, ro = 0;
  if constexpr (LN) {
    if (!producer && r < M) {
      rn = ln[r];
      ro = lo[r];
    }
  }

  if (producer) {
    if constexpr (PL) {
      // planes the stack lacks read as +0.0, as mainloop reads them; the
      // loads never write them
      for (int j = nst; j < nl; ++j)
        for (int q = 0; q < slots; ++q)
          for (int e = pt; e < dk * DEC_N; e += np) Bp[bp_at(q, j) + e] = zero;
    }
    for (int s = 0; s < NS - 1; ++s) {
      if (s < stages) load(s);
      cp_async_commit();
    }
    if (stages > 0) limb(0);
  }
  __syncthreads();
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    if (producer) {
      // the copies of stage s + NS - 1 and the limbs of stage s + 1 while
      // the compute warps run stage s
      if (s + NS - 1 < stages) load(s + NS - 1);
      cp_async_commit();
      if (s + 1 < stages) limb(s + 1);
    } else if (r < M) {
      const int kn = stage_k(s);
      const __nv_bfloat16* const arow = As + as_at(s & 1, 0) + r * dk;
      // this thread's column of each B's planes at this stage, plane
      // stride dk*16
      const __nv_bfloat16* bcol[NOUT];
#pragma unroll
      for (int t = 0; t < NOUT; ++t)
        bcol[t] = (PL ? Bp + bp_at(s % NS, 0) : Bl + bl_at(s & 1, t, 0)) + c;
      const int bs = dk * DEC_N;
      int kk = 0;
      // 8 k of A's planes (one 16-byte broadcast read each), and of weight
      // t's B column
      auto fetch_a = [&](int k8, uint4 (&av)[NL]) {
#pragma unroll
        for (int i = 0; i < NL; ++i)
          av[i] = *reinterpret_cast<const uint4*>(arow + i * plane + k8);
      };
      auto fetch_b = [&](int k8, int t, float (&bv)[NL][8]) {
#pragma unroll
        for (int j = 0; j < NL; ++j)
#pragma unroll
          for (int u = 0; u < 8; ++u)
            bv[j][u] = bf(bcol[t][j * bs + (k8 + u) * DEC_N]);
      };
      // 8 k of weight t's chains, k ascending
      auto run = [&](const uint4 (&av)[NL], const float (&bv)[NL][8], int t) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float a[NL], b[NL];
#pragma unroll
          for (int i = 0; i < NL; ++i) a[i] = bf_at(av[i], u);
#pragma unroll
          for (int j = 0; j < NL; ++j) b[j] = bv[j][u];
          fma_step<NL, NO, LN>(a, b, acc[t], nl, mo, rn, ro);
        }
      };
      if constexpr (!GEN && NL * NOUT <= 3) {
        // the next 8 k's shared-memory reads in flight while this 8's
        // FMAs run
        const int kn8 = kn & ~7;
        if (kn8 > 0) {
          uint4 av[NL];
          float bv[NOUT][NL][8];
          fetch_a(0, av);
#pragma unroll
          for (int t = 0; t < NOUT; ++t) fetch_b(0, t, bv[t]);
#pragma unroll 1
          for (kk = 8; kk < kn8; kk += 8) {
            uint4 an[NL];
            float bn[NOUT][NL][8];
            fetch_a(kk, an);
#pragma unroll
            for (int t = 0; t < NOUT; ++t) fetch_b(kk, t, bn[t]);
#pragma unroll
            for (int t = 0; t < NOUT; ++t) run(av, bv[t], t);
#pragma unroll
            for (int i = 0; i < NL; ++i) av[i] = an[i];
#pragma unroll
            for (int t = 0; t < NOUT; ++t)
#pragma unroll
              for (int j = 0; j < NL; ++j)
#pragma unroll
                for (int u = 0; u < 8; ++u) bv[t][j][u] = bn[t][j][u];
          }
#pragma unroll
          for (int t = 0; t < NOUT; ++t) run(av, bv[t], t);
          kk = kn8;
        }
      } else if constexpr (!GEN) {
        // weight by weight within each 8 k: every chain still takes its k
        // in ascending order
        for (; kk + 8 <= kn; kk += 8) {
          uint4 av[NL];
          fetch_a(kk, av);
#pragma unroll
          for (int t = 0; t < NOUT; ++t) {
            float bv[NL][8];
            fetch_b(kk, t, bv);
            run(av, bv, t);
          }
        }
      }
      for (; kk < kn; ++kk) {
        float a[NL], b[NL];
#pragma unroll
        for (int i = 0; i < NL; ++i)
          a[i] = i < nl ? bf(arow[i * plane + kk]) : 0.f;
#pragma unroll
        for (int t = 0; t < NOUT; ++t) {
#pragma unroll
          for (int j = 0; j < NL; ++j)
            b[j] = j < nl ? bf(bcol[t][j * bs + kk * DEC_N]) : 0.f;
          fma_step<NL, NO, LN>(a, b, acc[t], nl, mo, rn, ro);
        }
      }
    }
    __syncthreads();
  }
  if (producer || r >= M) return;
  if (K % BK != 0) {
    // mainloop's zero-filled k past the edge (see the invariant above)
    float z[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) z[i] = 0.f;
#pragma unroll
    for (int t = 0; t < NOUT; ++t)
      fma_step<NL, NO, LN>(z, z, acc[t], nl, mo, rn, ro);
  }
  const int64_t gn = n0 + c;
  if (gn >= N) return;
  // a lane row joins its own orders, from its own highest one down
  float y[NOUT];
#pragma unroll
  for (int t = 0; t < NOUT; ++t) y[t] = combine_orders<NO>(acc[t], LN ? ro : mo);
  store(r, gn, y);
}

// Port of _fused_kernel: C[z] = A[z] @ B[z] at the format, z over up to two
// batch dims with their own strides (a stride of 0 broadcasts), so decode
// attention's (B, H, 1, Dh) x (B, H, Dh, T) runs as one launch.
template <int NL, int NO, int RM, int RN, bool GEN>
__global__ void __launch_bounds__(NT) fused_matmul_kernel(MatmulArgs p) {
  const int64_t z = blockIdx.z;
  const int64_t z0 = z / p.nb1;
  const int64_t z1 = z % p.nb1;
  matmul_tile<NL, NO, RM, RN, GEN, false>(
      p.a + z0 * p.a_sb0 + z1 * p.a_sb1, p.a_sr, p.a_sc,
      p.b + z0 * p.b_sb0 + z1 * p.b_sb1, p.b_sr, p.b_sc, Planes{},
      p.c + z0 * p.c_sb0 + z1 * p.c_sb1, p.c_sr, p.c_sc, p.M, p.N, p.K,
      p.n_limbs, p.max_order);
}

// fused_matmul_kernel's decode tile (M <= DEC_M), one block per DEC_N
// columns and batch entry.
template <int NL, int NO, bool GEN>
__global__ void __launch_bounds__(DEC_M * DEC_N + 128)
    fused_matmul_decode_kernel(MatmulArgs p, int dk) {
  const int64_t z = blockIdx.z;
  const int64_t z0 = z / p.nb1;
  const int64_t z1 = z % p.nb1;
  const float* const B[1] = {p.b + z0 * p.b_sb0 + z1 * p.b_sb1};
  float* const C = p.c + z0 * p.c_sb0 + z1 * p.c_sb1;
  decode_tile<NL, NO, GEN, false>(
      p.a + z0 * p.a_sb0 + z1 * p.a_sb1, p.a_sr, p.a_sc, B, p.b_sr, p.b_sc,
      Planes{}, (int)p.M, p.N, p.K, p.n_limbs, p.max_order, dk, nullptr,
      nullptr, [&](int r, int64_t gn, const float (&y)[1]) {
        C[r * p.c_sr + gn * p.c_sc] = y[0];
      });
}

struct PrelimbedArgs {
  const float* a;        // (M, K), column stride 1
  Planes b;              // (L, K, N) limb planes, column stride 1
  float* c;              // (M, N), column stride 1
  int64_t a_sr, c_sr;
  int64_t M, N, K;
  int n_limbs, max_order;
};

// Port of _prelimbed_kernel (build_prelimbed_call(both=False)): A limbed on
// the fly, B read from its stored limb planes (the serving decode path's
// pre-limbed weights).  Same tiles, same per-order accumulators, same
// _combine_orders flush as fused_matmul_kernel: on planes decomposed from a
// raw weight it returns fused_matmul_kernel's result on that weight, bit for
// bit.  Bound at decode (M = 8) by the bytes of the planes it reads (an M8
// format reads plane 0 only: half the f32 weight's bytes).
template <int NL, int NO, int RM, int RN, bool GEN>
__global__ void __launch_bounds__(NT) prelimbed_matmul_kernel(PrelimbedArgs p) {
  matmul_tile<NL, NO, RM, RN, GEN, true>(p.a, p.a_sr, 1, nullptr, 0, 0, p.b,
                                         p.c, p.c_sr, 1, p.M, p.N, p.K,
                                         p.n_limbs, p.max_order);
}

// prelimbed_matmul_kernel's decode tile (M <= DEC_M): the serving decode
// path's matmuls.  Bound at M = 8 by the serial fmaf chain of each output
// (K steps of the deepest order's products) and by the planes' bytes.
template <int NL, int NO, bool GEN>
__global__ void __launch_bounds__(DEC_M * DEC_N + 128)
    prelimbed_matmul_decode_kernel(PrelimbedArgs p, int dk) {
  const float* const B[1] = {nullptr};
  decode_tile<NL, NO, GEN, true>(
      p.a, p.a_sr, 1, B, 0, 0, p.b, (int)p.M, p.N, p.K, p.n_limbs,
      p.max_order, dk, nullptr, nullptr,
      [&](int r, int64_t gn, const float (&y)[1]) {
        p.c[r * p.c_sr + gn] = y[0];
      });
}

struct MixedPrelimbedArgs {
  PrelimbedArgs m;          // the envelope's (n_limbs, max_order) in m
  const int32_t* lane_n;    // (M,) limbs of each row's lane
  const int32_t* lane_ord;  // (M,) order cut of each row's lane
};

// Port of _mixed_prelimbed_kernel (build_mixed_prelimbed_call): the
// pre-limbed kernel at the batch's envelope depth, each output row at its
// own lane format (lane_n[m], lane_ord[m]) at or below the envelope.  A
// product the row's lane leaves out skips its FMA (the TPU kernel adds a
// masked +0.0 instead), and the flush joins the row's orders from its own
// highest one down, so a row is bit for bit prelimbed_matmul_kernel's row at
// the lane's format, signs of zeros included.  One launch serves a decode
// micro-batch whose slots run different formats.  Bound like the pre-limbed
// kernel at decode (M = 8) by the bytes of the planes it reads: the
// envelope's, once for all rows.
template <int NL, int NO, int RM, int RN, bool GEN>
__global__ void __launch_bounds__(NT)
    mixed_prelimbed_matmul_kernel(MixedPrelimbedArgs p) {
  matmul_tile<NL, NO, RM, RN, GEN, true, true>(
      p.m.a, p.m.a_sr, 1, nullptr, 0, 0, p.m.b, p.m.c, p.m.c_sr, 1, p.m.M,
      p.m.N, p.m.K, p.m.n_limbs, p.m.max_order, p.lane_n, p.lane_ord);
}

// mixed_prelimbed_matmul_kernel's decode tile (M <= DEC_M): the mixed-format
// decode tick's matmuls.  The envelope's planes stream once for all rows;
// each compute thread cuts its own row's products, so a warp (two rows) runs
// at its deeper row's chain, and a row is the pre-limbed decode tile's row at
// its lane, bit for bit.  One block per SM is asked for (the ring leaves
// room for no more at most shapes): without it ptxas caps some
// instantiations at 80 registers, two blocks' worth, and spills.
template <int NL, int NO, bool GEN>
__global__ void __launch_bounds__(DEC_M * DEC_N + 128, 1)
    mixed_prelimbed_matmul_decode_kernel(MixedPrelimbedArgs p, int dk) {
  const float* const B[1] = {nullptr};
  decode_tile<NL, NO, GEN, true, true>(
      p.m.a, p.m.a_sr, 1, B, 0, 0, p.m.b, (int)p.m.M, p.m.N, p.m.K,
      p.m.n_limbs, p.m.max_order, dk, p.lane_n, p.lane_ord,
      [&](int r, int64_t gn, const float (&y)[1]) {
        p.m.c[r * p.m.c_sr + gn] = y[0];
      });
}

struct BothPrelimbedArgs {
  Planes a;              // (La, M, K) limb planes, column stride 1
  Planes b;              // (Lb, K, N) limb planes, column stride 1
  float* c;              // (M, N), column stride 1
  int64_t c_sr;
  int64_t M, N, K;
  int n_limbs, max_order;
};

// Port of _both_prelimbed_kernel (build_prelimbed_call(both=True)): both
// operands read from stored bf16 limb planes, the path of two-float (DD)
// operands, whose ~49 mantissa bits no f32 can hold (M36 and M52 on wider
// than fp32 inputs; the f32 side of a mixed DD x f32 call comes from the
// decompose kernel).  Same tiles, products, per-order accumulators and
// _combine_orders flush as fused_matmul_kernel, so on planes decomposed
// from f32 operands it returns fused_matmul_kernel's result on them, bit for
// bit.  Bound at the prefill shapes by its limb products (28 for M52), like
// the fused kernel: the planes it reads are half the bytes per limb of an
// f32 operand, but 7 of them are read.
template <int NL, int NO, int RM, int RN, bool GEN>
__global__ void __launch_bounds__(NT)
    both_prelimbed_matmul_kernel(BothPrelimbedArgs p) {
  matmul_tile<NL, NO, RM, RN, GEN, true, false, true>(
      nullptr, 0, 0, nullptr, 0, 0, p.b, p.c, p.c_sr, 1, p.M, p.N, p.K,
      p.n_limbs, p.max_order, nullptr, nullptr, p.a);
}

// Port of _decompose_kernel: x (n f32 values) -> n_limbs bf16 planes of n
// values each, the round-to-nearest-even cascade of extract_limbs (bitwise
// limbs.decompose).  Elementwise and bound by its bytes: each value is read
// once and each limb written once, neighbouring threads on neighbouring
// addresses.
__global__ void __launch_bounds__(256) decompose_kernel(
    const float* __restrict__ x, __nv_bfloat16* __restrict__ out, int64_t n,
    int n_limbs) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float r = x[i];
    for (int l = 0; l < n_limbs; ++l) {
      const __nv_bfloat16 li = __float2bfloat16_rn(r);
      out[l * n + i] = li;
      r = r - bf(li);
    }
  }
}

struct ProjArgs {
  const float* a;               // (M, K), column stride 1
  const float* b[MAX_OUT];      // n_out x (K, N), column stride 1
  const float* bias[MAX_OUT];   // n_out x (N,) or all null
  const float* res;             // (M, N) or null
  float* out;                   // (M, N) when gated, else (n_out, M, N)
  int64_t a_sr, b_sr, res_sr;
  int64_t M, N, K;
  int n_limbs, max_order, gate;
};

// The projection's epilogue of output (gm, gn) of weights t0 .. t0 + NOUT - 1
// (their combined sums y), before the single store, in _flush's order: bias,
// then silu(out0) * out1 (silu(x) = x / (1 + expf(-x)) in f32), then the
// residual.  Both projection tiles call it, so an output has the same bits
// whichever tile ran it.
template <int NOUT>
__device__ __forceinline__ void proj_store(const ProjArgs& p, int64_t gm,
                                           int64_t gn, int t0,
                                           float (&y)[NOUT]) {
#pragma unroll
  for (int t = 0; t < NOUT; ++t)
    if (p.bias[0] != nullptr) y[t] = y[t] + p.bias[t0 + t][gn];
  if (p.gate) {
    float g = 0.f;
    if constexpr (NOUT == 2) g = (y[0] / (1.0f + expf(-y[0]))) * y[1];
    if (p.res != nullptr) g = g + p.res[gm * p.res_sr + gn];
    p.out[gm * p.N + gn] = g;
  } else {
    if (p.res != nullptr) y[0] = y[0] + p.res[gm * p.res_sr + gn];
#pragma unroll
    for (int t = 0; t < NOUT; ++t)
      p.out[((t0 + t) * p.M + gm) * p.N + gn] = y[t];
  }
}

// Port of _fused_multi_kernel: the A tile is limbed once per K step and feeds
// every output; proj_store's epilogue runs before the single store.
template <int NL, int NO, int NOUT, int RM, int RN, bool GEN>
__global__ void __launch_bounds__(NT) fused_proj_kernel(ProjArgs p) {
  constexpr int BM = TY * RM;
  constexpr int BN = TX * RN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t n0 = (int64_t)blockIdx.x * BN;
  float acc[NOUT][NO][RM][RN];
  mainloop<NL, NO, NOUT, RM, RN, GEN>(p.a, p.a_sr, 1, p.b, p.b_sr, 1, p.M, p.N,
                                      p.K, m0, n0, p.n_limbs, p.max_order, acc);
  const int mo = GEN ? p.max_order : NO - 1;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int64_t gm = m0 + ty + r * TY;
      const int64_t gn = n0 + tx + c * TX;
      if (gm >= p.M || gn >= p.N) continue;
      float y[NOUT];
#pragma unroll
      for (int t = 0; t < NOUT; ++t) {
        float per_order[NO];
#pragma unroll
        for (int o = 0; o < NO; ++o) per_order[o] = acc[t][o][r][c];
        y[t] = combine_orders<NO>(per_order, mo);
      }
      proj_store<NOUT>(p, gm, gn, 0, y);
    }
  }
}

// fused_proj_kernel's decode tile (M <= DEC_M): A limbed once per stage for
// the block's NOUT weights, weights t0 = blockIdx.y * NOUT onwards (grid.y
// blocks of weights per column block), then proj_store.  NOUT = 1 without
// the gate; the swiglu gate needs g and u of one output in one thread, so
// it runs NOUT = 2.  One block per SM is asked for, as for the mixed decode
// kernel.
template <int NL, int NO, int NOUT, bool GEN>
__global__ void __launch_bounds__(DEC_M * DEC_N + 128, 1)
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
      });
}

// micro-tile per thread: 4 x 4 while the accumulators stay within ~112
// registers, else 2 x 2 (the generic instantiation, wide fused groups)
constexpr int micro(int no, int nout, bool gen) {
  return (!gen && no * nout <= 7) ? 4 : 2;
}

// Launch one decode-tile kernel: blocks of M * DEC_N compute threads and the
// producer warps over the N columns (x), ny groups of NOUT weights (y) and
// the batch (z).  k per stage is DecRing's, halved until NOUT weights' rings
// and planes fit the card's shared memory and, where the grid has more
// blocks than the card has SMs, until two blocks fit on one SM (down to 64
// k).  It only stages the loads: every chain keeps its order, so the bits do
// not depend on it.  The kernel's dynamic shared memory limit is raised to
// the card's once per kernel.
template <int NL, int NOUT, auto kernel, typename Args>
cudaError_t launch_decode(const Args& p, bool pl, int nl, int64_t M,
                          int64_t N, int64_t K, unsigned ny, int64_t nz,
                          cudaStream_t st) {
  static int optin = 0, sms = 0, sm_smem = 0;
  if (optin == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) {
      optin = 0;
      return err;
    }
  }
  auto smem_of = [&](int dk) {
    const int64_t stages = dk > 0 ? (K + dk - 1) / dk : 0;
    const int slots =
        (int)(stages < DecRing<NL>::S ? stages : DecRing<NL>::S);
    return dec_smem_bytes(pl, nl, (int)M, dk, slots, NOUT);
  };
  int dk = (int)(K < DecRing<NL>::K ? (K + 7) / 8 * 8 : DecRing<NL>::K);
  while (dk > 8 && smem_of(dk) > optin) dk = (dk / 2 + 7) / 8 * 8;
  const dim3 grid((unsigned)((N + DEC_N - 1) / DEC_N), ny, (unsigned)nz);
  if ((int64_t)grid.x * grid.y * grid.z > sms)
    // 1 KB of each block's shared memory is the runtime's
    while (dk > 64 && 2 * (smem_of(dk) + 1024) > sm_smem)
      dk = (dk / 2 + 7) / 8 * 8;
  const int64_t smem = smem_of(dk);
  const unsigned threads =
      (unsigned)(dec_compute_threads((int)M) + 32 * DecRing<NL>::P(pl));
  kernel<<<grid, threads, (size_t)smem, st>>>(p, dk);
  return cudaGetLastError();
}

// M <= DEC_M takes the decode tile, larger M the (TY * R) x (TX * R) tile;
// both give every output the same bits
template <int NL, int NO, bool GEN>
cudaError_t launch_matmul(const MatmulArgs& p, int64_t nb0, cudaStream_t st) {
  if (p.M <= DEC_M)
    return launch_decode<NL, 1, fused_matmul_decode_kernel<NL, NO, GEN>>(
        p, false, GEN ? p.n_limbs : NL, p.M, p.N, p.K, 1, nb0 * p.nb1, st);
  constexpr int R = micro(NO, 1, GEN);
  const dim3 grid((unsigned)((p.N + TX * R - 1) / (TX * R)),
                  (unsigned)((p.M + TY * R - 1) / (TY * R)),
                  (unsigned)(nb0 * p.nb1));
  fused_matmul_kernel<NL, NO, R, R, GEN><<<grid, NT, 0, st>>>(p);
  return cudaGetLastError();
}

// the tile choice is launch_matmul's, so the two kernels tile alike
template <int NL, int NO, bool GEN>
cudaError_t launch_prelimbed(const PrelimbedArgs& p, cudaStream_t st) {
  if (p.M <= DEC_M)
    return launch_decode<NL, 1, prelimbed_matmul_decode_kernel<NL, NO, GEN>>(
        p, true, GEN ? p.n_limbs : NL, p.M, p.N, p.K, 1, 1, st);
  constexpr int R = micro(NO, 1, GEN);
  const dim3 grid((unsigned)((p.N + TX * R - 1) / (TX * R)),
                  (unsigned)((p.M + TY * R - 1) / (TY * R)), 1);
  prelimbed_matmul_kernel<NL, NO, R, R, GEN><<<grid, NT, 0, st>>>(p);
  return cudaGetLastError();
}

template <int NL, int NO, bool GEN>
cudaError_t launch_mixed_prelimbed(const MixedPrelimbedArgs& p,
                                   cudaStream_t st) {
  if (p.m.M <= DEC_M)
    return launch_decode<NL, 1,
                         mixed_prelimbed_matmul_decode_kernel<NL, NO, GEN>>(
        p, true, GEN ? p.m.n_limbs : NL, p.m.M, p.m.N, p.m.K, 1, 1, st);
  constexpr int R = micro(NO, 1, GEN);
  const dim3 grid((unsigned)((p.m.N + TX * R - 1) / (TX * R)),
                  (unsigned)((p.m.M + TY * R - 1) / (TY * R)), 1);
  mixed_prelimbed_matmul_kernel<NL, NO, R, R, GEN><<<grid, NT, 0, st>>>(p);
  return cudaGetLastError();
}

template <int NL, int NO, bool GEN>
cudaError_t launch_both_prelimbed(const BothPrelimbedArgs& p,
                                  cudaStream_t st) {
  constexpr int R = micro(NO, 1, GEN);
  const dim3 grid((unsigned)((p.N + TX * R - 1) / (TX * R)),
                  (unsigned)((p.M + TY * R - 1) / (TY * R)), 1);
  both_prelimbed_matmul_kernel<NL, NO, R, R, GEN><<<grid, NT, 0, st>>>(p);
  return cudaGetLastError();
}

// At M <= DEC_M the decode tile: one block per (column block, weight)
// without the gate (QKV's 768 columns: 144 blocks, 1.3x faster than the
// three weights in one block), both weights in one block with it (the gate
// needs g and u of one output in one thread).
template <int NL, int NO, int NOUT, bool GEN>
cudaError_t launch_proj(const ProjArgs& p, cudaStream_t st) {
  if (p.M <= DEC_M) {
    const int nl = GEN ? p.n_limbs : NL;
    if constexpr (NOUT == 2)
      if (p.gate)
        return launch_decode<NL, 2, fused_proj_decode_kernel<NL, NO, 2, GEN>>(
            p, false, nl, p.M, p.N, p.K, 1, 1, st);
    return launch_decode<NL, 1, fused_proj_decode_kernel<NL, NO, 1, GEN>>(
        p, false, nl, p.M, p.N, p.K, NOUT, 1, st);
  }
  constexpr int R = micro(NO, NOUT, GEN);
  const dim3 grid((unsigned)((p.N + TX * R - 1) / (TX * R)),
                  (unsigned)((p.M + TY * R - 1) / (TY * R)), 1);
  fused_proj_kernel<NL, NO, NOUT, R, R, GEN><<<grid, NT, 0, st>>>(p);
  return cudaGetLastError();
}

template <int NOUT>
cudaError_t proj_for_format(const ProjArgs& p, cudaStream_t st) {
  const int nl = p.n_limbs;
  const int mo = p.max_order;
  if (nl == 1 && mo == 0) return launch_proj<1, 1, NOUT, false>(p, st);
  if (nl == 2 && mo == 1) return launch_proj<2, 2, NOUT, false>(p, st);
  if (nl == 3 && mo == 2) return launch_proj<3, 3, NOUT, false>(p, st);
  if (nl == 5 && mo == 4) return launch_proj<5, 5, NOUT, false>(p, st);
  if (nl == 7 && mo == 6) return launch_proj<7, 7, NOUT, false>(p, st);
  return launch_proj<GEN_NL, GEN_NO, NOUT, true>(p, st);
}

bool format_ok(int64_t n_limbs, int64_t max_order) {
  return n_limbs >= 1 && n_limbs <= GEN_NL && max_order >= 0 &&
         max_order <= 2 * (n_limbs - 1);
}

}  // namespace

extern "C" {

// C[z] (M, N) = A[z] (M, K) @ B[z] (K, N) at (n_limbs, max_order); strides in
// elements; z = z0 * nb1 + z1 over nb0 * nb1 batches.  Returns the CUDA error
// of the launch (0 on success).  Allocates nothing and does not synchronise.
int mp_fused_matmul_launch(const void* a, int64_t a_sb0, int64_t a_sb1,
                           int64_t a_sr, int64_t a_sc, const void* b,
                           int64_t b_sb0, int64_t b_sb1, int64_t b_sr,
                           int64_t b_sc, void* c, int64_t c_sb0, int64_t c_sb1,
                           int64_t c_sr, int64_t c_sc, int64_t nb0, int64_t nb1,
                           int64_t M, int64_t N, int64_t K, int64_t n_limbs,
                           int64_t max_order, void* stream) {
  if (!format_ok(n_limbs, max_order) || nb0 < 1 || nb1 < 1 ||
      nb0 * nb1 > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  MatmulArgs p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<float*>(c), a_sb0, a_sb1, a_sr, a_sc, b_sb0, b_sb1,
               b_sr, b_sc, c_sb0, c_sb1, c_sr, c_sc, nb1, M, N, K,
               (int)n_limbs, (int)max_order};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nl = (int)n_limbs;
  const int mo = (int)max_order;
  cudaError_t err;
  if (nl == 1 && mo == 0) err = launch_matmul<1, 1, false>(p, nb0, st);
  else if (nl == 2 && mo == 1) err = launch_matmul<2, 2, false>(p, nb0, st);
  else if (nl == 3 && mo == 2) err = launch_matmul<3, 3, false>(p, nb0, st);
  else if (nl == 5 && mo == 4) err = launch_matmul<5, 5, false>(p, nb0, st);
  else if (nl == 7 && mo == 6) err = launch_matmul<7, 7, false>(p, nb0, st);
  else err = launch_matmul<GEN_NL, GEN_NO, true>(p, nb0, st);
  return (int)err;
}

// out = epilogue(A @ B_t for t < n_out) at (n_limbs, max_order).  A (M, K)
// and each B_t (K, N) have column stride 1 and the given row strides; biases
// are n_out (N,) vectors or all null; res (M, N) or null; gate 1 = swiglu
// (n_out must be 2, out (M, N)), else out is (n_out, M, N) contiguous.
int mp_fused_proj_launch(const void* a, int64_t a_sr, const void* b0,
                         const void* b1, const void* b2, int64_t b_sr,
                         const void* bias0, const void* bias1,
                         const void* bias2, const void* res, int64_t res_sr,
                         void* out, int64_t n_out, int64_t gate, int64_t M,
                         int64_t N, int64_t K, int64_t n_limbs,
                         int64_t max_order, void* stream) {
  if (!format_ok(n_limbs, max_order) || n_out < 1 || n_out > MAX_OUT ||
      (gate && n_out != 2) || (res != nullptr && !gate && n_out != 1))
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n_out == 1) err = proj_for_format<1>(p, st);
  else if (n_out == 2) err = proj_for_format<2>(p, st);
  else err = proj_for_format<3>(p, st);
  return (int)err;
}

// C (M, N) = A (M, K) @ B at (n_limbs, max_order), B given as n_stored bf16
// limb planes (plane stride b_plane, row stride b_sr; column strides of A,
// the planes and C are 1).  Planes at or past min(n_stored, n_limbs) are
// never read.  Returns the CUDA error of the launch (0 on success).
// Allocates nothing and does not synchronise.
int mp_prelimbed_matmul_launch(const void* a, int64_t a_sr, const void* b,
                               int64_t b_plane, int64_t b_sr,
                               int64_t n_stored, void* c, int64_t c_sr,
                               int64_t M, int64_t N, int64_t K,
                               int64_t n_limbs, int64_t max_order,
                               void* stream) {
  if (!format_ok(n_limbs, max_order) || n_stored < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  PrelimbedArgs p{};
  p.a = static_cast<const float*>(a);
  p.b = Planes{static_cast<const __nv_bfloat16*>(b), b_plane, b_sr,
               (int)n_stored};
  p.c = static_cast<float*>(c);
  p.a_sr = a_sr;
  p.c_sr = c_sr;
  p.M = M;
  p.N = N;
  p.K = K;
  p.n_limbs = (int)n_limbs;
  p.max_order = (int)max_order;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nl = (int)n_limbs;
  const int mo = (int)max_order;
  cudaError_t err;
  if (nl == 1 && mo == 0) err = launch_prelimbed<1, 1, false>(p, st);
  else if (nl == 2 && mo == 1) err = launch_prelimbed<2, 2, false>(p, st);
  else if (nl == 3 && mo == 2) err = launch_prelimbed<3, 3, false>(p, st);
  else if (nl == 5 && mo == 4) err = launch_prelimbed<5, 5, false>(p, st);
  else if (nl == 7 && mo == 6) err = launch_prelimbed<7, 7, false>(p, st);
  else err = launch_prelimbed<GEN_NL, GEN_NO, true>(p, st);
  return (int)err;
}

// C (M, N) = A (M, K) @ B with row m at its own lane format (lane_n[m]
// limbs, order cut lane_ord[m]) at or below the envelope (n_limbs,
// max_order); A, B and C as in mp_prelimbed_matmul_launch, lane_n and
// lane_ord (M,) int32 on the device.  Planes at or past min(n_stored,
// n_limbs) are never read.  Returns the CUDA error of the launch (0 on
// success).  Allocates nothing and does not synchronise.
int mp_mixed_prelimbed_matmul_launch(const void* a, int64_t a_sr,
                                     const void* b, int64_t b_plane,
                                     int64_t b_sr, int64_t n_stored,
                                     const void* lane_n, const void* lane_ord,
                                     void* c, int64_t c_sr, int64_t M,
                                     int64_t N, int64_t K, int64_t n_limbs,
                                     int64_t max_order, void* stream) {
  if (!format_ok(n_limbs, max_order) || n_stored < 1 || lane_n == nullptr ||
      lane_ord == nullptr)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  MixedPrelimbedArgs p{};
  p.m.a = static_cast<const float*>(a);
  p.m.b = Planes{static_cast<const __nv_bfloat16*>(b), b_plane, b_sr,
                 (int)n_stored};
  p.m.c = static_cast<float*>(c);
  p.m.a_sr = a_sr;
  p.m.c_sr = c_sr;
  p.m.M = M;
  p.m.N = N;
  p.m.K = K;
  p.m.n_limbs = (int)n_limbs;
  p.m.max_order = (int)max_order;
  p.lane_n = static_cast<const int32_t*>(lane_n);
  p.lane_ord = static_cast<const int32_t*>(lane_ord);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nl = (int)n_limbs;
  const int mo = (int)max_order;
  cudaError_t err;
  if (nl == 1 && mo == 0) err = launch_mixed_prelimbed<1, 1, false>(p, st);
  else if (nl == 2 && mo == 1) err = launch_mixed_prelimbed<2, 2, false>(p, st);
  else if (nl == 3 && mo == 2) err = launch_mixed_prelimbed<3, 3, false>(p, st);
  else if (nl == 5 && mo == 4) err = launch_mixed_prelimbed<5, 5, false>(p, st);
  else if (nl == 7 && mo == 6) err = launch_mixed_prelimbed<7, 7, false>(p, st);
  else err = launch_mixed_prelimbed<GEN_NL, GEN_NO, true>(p, st);
  return (int)err;
}

// C (M, N) = A @ B at (n_limbs, max_order), A given as na_stored bf16 limb
// planes of (M, K) (plane stride a_plane, row stride a_sr) and B as
// nb_stored planes of (K, N) (b_plane, b_sr); column strides of the planes
// and C are 1.  Planes at or past min(n_stored, n_limbs) of either operand
// are never read.  Returns the CUDA error of the launch (0 on success).
// Allocates nothing and does not synchronise.
int mp_both_prelimbed_matmul_launch(const void* a, int64_t a_plane,
                                    int64_t a_sr, int64_t na_stored,
                                    const void* b, int64_t b_plane,
                                    int64_t b_sr, int64_t nb_stored, void* c,
                                    int64_t c_sr, int64_t M, int64_t N,
                                    int64_t K, int64_t n_limbs,
                                    int64_t max_order, void* stream) {
  if (!format_ok(n_limbs, max_order) || na_stored < 1 || nb_stored < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  BothPrelimbedArgs p{};
  p.a = Planes{static_cast<const __nv_bfloat16*>(a), a_plane, a_sr,
               (int)na_stored};
  p.b = Planes{static_cast<const __nv_bfloat16*>(b), b_plane, b_sr,
               (int)nb_stored};
  p.c = static_cast<float*>(c);
  p.c_sr = c_sr;
  p.M = M;
  p.N = N;
  p.K = K;
  p.n_limbs = (int)n_limbs;
  p.max_order = (int)max_order;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nl = (int)n_limbs;
  const int mo = (int)max_order;
  cudaError_t err;
  if (nl == 1 && mo == 0) err = launch_both_prelimbed<1, 1, false>(p, st);
  else if (nl == 2 && mo == 1) err = launch_both_prelimbed<2, 2, false>(p, st);
  else if (nl == 3 && mo == 2) err = launch_both_prelimbed<3, 3, false>(p, st);
  else if (nl == 5 && mo == 4) err = launch_both_prelimbed<5, 5, false>(p, st);
  else if (nl == 7 && mo == 6) err = launch_both_prelimbed<7, 7, false>(p, st);
  else err = launch_both_prelimbed<GEN_NL, GEN_NO, true>(p, st);
  return (int)err;
}

// out (n_limbs planes of n bf16) = the limb cascade of x (n f32, contiguous).
// Returns the CUDA error of the launch (0 on success).
int mp_decompose_launch(const void* x, void* out, int64_t n, int64_t n_limbs,
                        void* stream) {
  if (n_limbs < 1 || n_limbs > GEN_NL || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t blocks = (n + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
  decompose_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(out), n,
      (int)n_limbs);
  return (int)cudaGetLastError();
}

}  // extern "C"
