// Multi-precision limb matmul kernels for Hopper (sm_90a), plain C interface.
//
// Ports of the Pallas TPU kernels in src/repro/kernels/mp_matmul.py:
//
//   fused_matmul_kernel  replaces _fused_kernel        (one output, batched,
//                                                      arbitrary strides: the
//                                                      prefill tile of the
//                                                      operands TMA cannot
//                                                      read; the decode and
//                                                      TMA tiles are in
//                                                      mp_matmul_hopper.cu)
//     <PARTS> (mp_fused_matmul_partials_launch) replaces no TPU kernel: the
//                                                      per-order stack of the
//                                                      K-sharded backend's
//                                                      local step
//   fused_proj_kernel    replaces _fused_multi_kernel  (one A operand shared
//                                                      by n_out B operands,
//                                                      bias / swiglu / residual
//                                                      epilogue: the prefill
//                                                      tile of the operands
//                                                      TMA cannot read; the
//                                                      TMA and split decode
//                                                      tiles are in
//                                                      mp_matmul_hopper.cu)
//   prelimbed_matmul_kernel  replaces _prelimbed_kernel  (B as stored bf16
//                                                      limb planes: the
//                                                      prefill tile; the
//                                                      serving decode's split
//                                                      tile is in
//                                                      mp_matmul_hopper.cu)
//   decompose_kernel     replaces _decompose_kernel    (f32 -> bf16 limb
//                                                      planes, once per
//                                                      policy)
//   mixed_prelimbed_matmul_kernel  replaces _mixed_prelimbed_kernel  (the
//                                                      pre-limbed kernel at a
//                                                      batch's envelope
//                                                      depth, each row at its
//                                                      own lane format: the
//                                                      prefill tile; the
//                                                      mixed-format decode's
//                                                      split tile is in
//                                                      mp_matmul_hopper.cu)
//   both_prelimbed_matmul_kernel  replaces _both_prelimbed_kernel  (A and B
//                                                      both as stored bf16
//                                                      limb planes: two-float
//                                                      DD operands, modes 5
//                                                      and 6; the run-time
//                                                      formats and the planes
//                                                      no tensor map reads;
//                                                      the TMA tile is in
//                                                      mp_matmul_hopper.cu)
//
// What they compute: C = sum over the format's kept limb pairs (i, j) of
// A_i * B_j, where X_i is the i-th bf16 limb of the f32 operand (the
// round-to-nearest cascade l0 = bf16(x), l1 = bf16(x - l0), ...).  One f32
// accumulator per limb-product order o = i + j is carried across the whole K
// loop, and the orders are joined at the end by the Neumaier-compensated
// combine of _combine_orders: start from the highest order, walk down, and
// take the |s| >= |t| branch of the compensation.
//
// The order of the sum is one order for every kernel and both tiles; it is
// what keeps pre-limbed == fused, a mixed row == its homogeneous row, rows at
// M <= 16 == rows at M = 70, the projection without an epilogue == the fused
// matmul and scheduled == solo bit for bit.  K runs in chunks of KC from
// k = 0, zero-filled up to a multiple of KC.  For each chunk, each order o
// and each kept product (i, j) of o, i ascending (the format's product
// order), frag = A_i[:, chunk] @ B_j[chunk, :] is one chain of KC / 16
// tensor-core MMAs (mma.sync m16n8k16, bf16 operands, f32 accumulator,
// starting from +0.0); the order's terms are summed by IEEE f32 adds on the
// CUDA cores, tot = the first term, then tot = tot + frag; then acc[o] =
// acc[o] + tot.  That is _fused_kernel's body with its block depth set to
// KC: the tensor core's own f32 summation, which is not IEEE round to
// nearest, never spans more than one chunk's KC products, and every longer
// sum is IEEE adds.  The rows of an MMA never interact, so a row's bits
// depend neither on M nor on the tile that ran it.  Lanes (LN): a row whose
// lane leaves out product (i, j) does not add its frag (a selection in
// registers: a thread's accumulators belong to rows lane / 4 and lane / 4 + 8
// of each fragment) and starts each order's sum at its own first kept term,
// so it performs exactly the adds of a homogeneous run at its lane.  Planes
// at or past a stack's stored count read as +0.0, and their products run
// like any other.  Both tiles run the last chunk on zero-filled planes, so
// zero signs come out of both alike.
//
// What bounds them on this card, and what the design does about it:
//
// The prefill shapes (M > 16) take the tile of mainloop: 8 warps of 32
// threads, 2 x 4 warps of (WM x WN) outputs each.  Registers set the tile:
// each output carries NOUT x (orders) accumulators plus the order's running
// sum and the chain, so the block tile is 128 x 128 for M8 (64 outputs per
// thread; 64 x 128 at two blocks per SM was slower on the H100) and shrinks
// to 64 x 128, 64 x 64, 32 x 64 and 32 x 32 as that count grows (Tile).
// Every operand element is read from device memory once per tile, by
// cp.async into an f32 staging buffer one or two stages ahead, and limbed
// once per block into bf16 planes in shared memory whose rows are padded by
// 16 bytes, so that ldmatrix reads them without bank conflicts; the blocks
// walk M first, so that a weight larger than the L2 cache is read about
// once; the multi-output kernel limbs its A tile once for all NOUT weights;
// stored planes are copied as they are.  Where two plane buffers fit, half
// the warps limb the next stage while the other half run this stage's MMAs,
// so the limbing and the MMAs overlap.  The one- and two-limb formats run
// all their products' chains in one pass over a chunk, so a limb's fragments
// are read once per k16 step.  What is left bounds them: the limbing and
// the copies' instructions on the CUDA cores, the fragment reads from
// shared memory, and the rate of mma.sync.  The operands a tensor map
// reads take the wgmma and TMA tiles of mp_matmul_hopper.cu instead, the
// fused matmul's, the projection's and the both-prelimbed matmul's; this
// tile keeps their strided operands (the both-prelimbed matmul's: planes
// no tensor map reads, and its run-time formats at any layout) and the
// prefill shapes of the pre-limbed and mixed-lane kernels.
//
// The decode shapes (M <= 16 rows) of every limb matmul take the decode
// tile (decode_tile, in mp_matmul_common.cuh), split over a cluster in
// mp_matmul_hopper.cu: the rows padded to one m16 fragment, 16 columns
// per block, B streamed through a ring by producer warps that limb it once
// per block.  Ragged edges are masked in the loads and stores; nothing is
// padded in device memory.
//
// Launch parameters the order leaves free, which the autotuner
// (kernels/autotune.py) may set per launch, as an argument of
// mp_fused_proj_launch: the prefill tile's outputs per thread (tile_e's, or
// half of it for the built-in formats).  They move work between blocks,
// never an add.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (no --use_fast_math).  --fmad=false keeps every a*b+c rounded twice, as
// the PyTorch plain versions round it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mp_matmul_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The prefill tile (M > DEC_M).

constexpr int NT = 256;           // threads per block: 2 x 4 warps
constexpr int WGM = 2;            // warps along M
constexpr int WGN = 4;            // warps along N

// outputs per thread: the most (64, 32, 16, 8 or 4) whose registers fit a
// budget.  Per output: NOUT x orders accumulators plus the live chains (one
// limb: one chain; two limbs: the three products' chains, run together;
// three or more, and the lane kernels: the order's running sum and one
// chain).  The budget, 160
// registers for one weight of one or two limbs, 128 for more weights and
// 144 for deeper formats, is where ptxas stopped spilling in the H100 build
__host__ __device__ constexpr int tile_e(int nl, int no, int nout) {
  const int c = nout * no + (nl == 1 ? 1 : nl == 2 ? 3 : 2);
  const int budget = nl >= 3 ? 144 : nout == 1 ? 160 : 128;
  return c * 64 <= budget ? 64
       : c * 32 <= budget ? 32
       : c * 16 <= budget ? 16
       : c * 8 <= budget  ? 8
                          : 4;
}

// The tile's shape from its outputs per thread E: warp tiles (WM x WN), the
// block's (BM x BN); and its dynamic shared memory: RS stages of f32 staging
// of A (unless A comes as planes, PLA) and of the NOUT Bs (unless B comes as
// planes, PL), then NPB buffers of A's limb planes [NL][BM][AP] and the Bs'
// [NOUT][NL][KC][BP], rows padded by PADE.  Two plane buffers (DP: the limbs
// of the next stage written while this stage's MMAs run) where the f32
// kernels fit them, else one; RS is 2 (the copies run two stages ahead)
// where that fits too, else 1.  mp_tile_smem_bytes exports the formula.
__host__ __device__ constexpr int tile_wm(int e) {
  return e == 64 ? 64 : e >= 16 ? 32 : 16;
}

__host__ __device__ constexpr int64_t tile_smem_bytes(int nl, int nout,
                                                      int e, bool pl,
                                                      bool pla) {
  const int64_t bm = WGM * tile_wm(e);
  const int64_t bn = WGN * (e * 32 / tile_wm(e));
  const int64_t raw = (pla ? 0 : bm * KC * 4) + (pl ? 0 : nout * KC * bn * 4);
  const int64_t planes = (int64_t)nl * bm * (KC + PADE) * 2 +
                         (int64_t)nout * nl * KC * (bn + PADE) * 2;
  const int npb = !pl && !pla && raw + 2 * planes <= SMEM_MAX ? 2 : 1;
  const int rs = 2 * raw + npb * planes <= SMEM_MAX ? 2 : 1;
  return rs * raw + npb * planes;
}

// The tile of one format, weight count and outputs per thread (tile_e's by
// default; the autotuner may launch E / 2, which changes no bit: a row's
// sums do not depend on the tile that runs it): warp tiles (WM x WN) of FM x
// FN MMA fragments, the block's (BM x BN) and its dynamic shared memory.
template <int NL, int NO, int NOUT, int E_ = tile_e(NL, NO, NOUT)>
struct Tile {
  static constexpr int E = E_;
  static constexpr int WM = tile_wm(E);
  static constexpr int WN = E * 32 / WM;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 8;
  static constexpr int BM = WGM * WM;
  static constexpr int BN = WGN * WN;
  static constexpr int AP = KC + PADE;
  static constexpr int BP = BN + PADE;
  __host__ __device__ static constexpr int64_t raw_a(bool pla) {
    return pla ? 0 : (int64_t)BM * KC * 4;
  }
  __host__ __device__ static constexpr int64_t raw_b(bool pl) {
    return pl ? 0 : (int64_t)NOUT * KC * BN * 4;
  }
  __host__ __device__ static constexpr int64_t planes() {
    return (int64_t)NL * BM * AP * 2 + (int64_t)NOUT * NL * KC * BP * 2;
  }
  __host__ __device__ static constexpr bool DP(bool pl, bool pla) {
    return !pl && !pla && raw_a(pla) + raw_b(pl) + 2 * planes() <= SMEM_MAX;
  }
  __host__ __device__ static constexpr int NPB(bool pl, bool pla) {
    return DP(pl, pla) ? 2 : 1;
  }
  __host__ __device__ static constexpr int RS(bool pl, bool pla) {
    return 2 * (raw_a(pla) + raw_b(pl)) + NPB(pl, pla) * planes() <= SMEM_MAX
               ? 2
               : 1;
  }
  __host__ __device__ static constexpr int64_t smem(bool pl, bool pla) {
    return RS(pl, pla) * (raw_a(pla) + raw_b(pl)) + NPB(pl, pla) * planes();
  }
  static_assert(smem(false, false) ==
                        tile_smem_bytes(NL, NOUT, E, false, false) &&
                    smem(true, false) ==
                        tile_smem_bytes(NL, NOUT, E, true, false) &&
                    smem(true, true) == tile_smem_bytes(NL, NOUT, E, true, true),
                "tile_smem_bytes is Tile::smem");
};

template <int NL, int NO, int NOUT, int E = tile_e(NL, NO, NOUT)>
using Acc = float[NOUT][NO][Tile<NL, NO, NOUT, E>::FM]
                 [Tile<NL, NO, NOUT, E>::FN][4];

// The shared main loop of the prefill tile: accumulates, for NOUT weights at
// once, the (BM x BN) outputs at (m0, n0) into per-order accumulators, in
// the order of chunk_step, one stage of KC k at a time.  PL: B comes as
// stored limb planes (``bp``, NOUT == 1) instead of f32 values limbed here;
// the products and the order of every add are the same either way, so a
// pre-limbed run is bitwise the f32 run on the weight the planes came from.
// LN: each row m runs at its own lane (ln[m] limbs, order cut lo[m]) at or
// below the (n_limbs, max_order) envelope.  PLA: A comes as stored limb
// planes too (``ap``); on planes cut from f32 operands the run is bitwise
// the f32 run, as for PL.
template <int NL, int NO, int NOUT, bool GEN, bool PL = false,
          bool LN = false, bool PLA = false, int E = tile_e(NL, NO, NOUT)>
__device__ __forceinline__ void mainloop(
    const float* __restrict__ A, int64_t a_sr, int64_t a_sc,
    const float* const* B, int64_t b_sr, int64_t b_sc, int64_t M, int64_t N,
    int64_t K, int64_t m0, int64_t n0, int n_limbs, int max_order,
    Acc<NL, NO, NOUT, E>& acc, Planes bp = Planes{},
    const int32_t* __restrict__ ln = nullptr,
    const int32_t* __restrict__ lo = nullptr, Planes ap = Planes{}) {
  using T = Tile<NL, NO, NOUT, E>;
  constexpr int BM = T::BM, BN = T::BN, WM = T::WM, WN = T::WN;
  constexpr int FM = T::FM, FN = T::FN, AP = T::AP, BP = T::BP;
  static_assert(T::smem(PL, PLA) <= SMEM_MAX, "tile exceeds shared memory");
  static_assert(!PL || NOUT == 1, "stored planes come for one weight");
  extern __shared__ __align__(16) unsigned char tile_smem[];
  // staging slot r: A's at Ar0 + r * BM * KC, the Bs' at Br0 + r * NOUT *
  // KC * BN; planes buffer b: A's at As0 + b * PB, the Bs' at Bs0 + b * PB
  constexpr int RS = T::RS(PL, PLA);
  constexpr bool DP = T::DP(PL, PLA);
  constexpr int PB = (int)(T::planes() / 2);
  float* const Ar0 = reinterpret_cast<float*>(tile_smem);
  float* const Br0 = reinterpret_cast<float*>(tile_smem + RS * T::raw_a(PLA));
  __nv_bfloat16* const As0 = reinterpret_cast<__nv_bfloat16*>(
      tile_smem + RS * (T::raw_a(PLA) + T::raw_b(PL)));
  __nv_bfloat16* const Bs0 = As0 + NL * BM * AP;
  int cb = 0;  // the planes buffer the MMAs read

  // built-in instantiations fold these to constants
  const int nl = GEN ? n_limbs : NL;
  const int mo = GEN ? max_order : NO - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) / WGN;
  const int wn = (tid >> 5) % WGN;

#pragma unroll
  for (int t = 0; t < NOUT; ++t)
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int mf = 0; mf < FM; ++mf)
#pragma unroll
        for (int nf = 0; nf < FN; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][o][mf][nf][e] = 0.f;

  // the lanes of this thread's rows, in registers for the whole K loop
  int rn[FM][2], ro[FM][2];
#pragma unroll
  for (int mf = 0; mf < FM; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gm = m0 + wm * WM + mf * 16 + (lane >> 2) + 8 * h;
      rn[mf][h] = LN && gm < M ? ln[gm] : PAD_N;
      ro[mf][h] = LN && gm < M ? lo[gm] : PAD_ORD;
    }

  // 16-byte copies where rows are contiguous and aligned (stored planes:
  // and whole 16-byte chunks up to the edge)
  const bool vec_a =
      PLA ? ap.sr % 8 == 0 && ap.plane % 8 == 0 && K % 8 == 0 &&
                aligned16(ap.p)
          : a_sc == 1 && a_sr % 4 == 0 && aligned16(A);
  bool vec_b = PL ? bp.sr % 8 == 0 && bp.plane % 8 == 0 && N % 8 == 0 &&
                        aligned16(bp.p)
                  : b_sc == 1 && b_sr % 4 == 0;
  if constexpr (!PL) {
#pragma unroll
    for (int t = 0; t < NOUT; ++t) vec_b = vec_b && aligned16(B[t]);
  }
  const int nsa = ap.n_stored < nl ? ap.n_stored : nl;
  const int nsb = bp.n_stored < nl ? bp.n_stored : nl;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // fixed positions of this thread's 16-byte chunks in a stage: A's rows
  // ra + i * RA at k ka .. ka + 3, B's k rows kb + i * RB at columns nb ..
  // nb + 3 (stored planes: 8 k or 8 columns, at ra8 / ka8, kb8 / nb8)
  constexpr int RA = NT / (KC / 4), NA = BM / RA;
  constexpr int RB = NT / (BN / 4), NB = KC / RB;
  constexpr int RA8 = NT / (KC / 8), RB8 = NT / (BN / 8);
  static_assert(BM % RA == 0 && KC % RB == 0 && BM % RA8 == 0 &&
                    KC % RB8 == 0,
                "every thread copies the same number of chunks");
  const int ra = tid / (KC / 4), ka = (tid % (KC / 4)) * 4;
  const int kb = tid / (BN / 4), nb = (tid % (BN / 4)) * 4;
  const int ra8 = tid / (KC / 8), ka8 = (tid % (KC / 8)) * 8;
  const int kb8 = tid / (BN / 8), nb8 = (tid % (BN / 8)) * 8;
  const float* const a_row = PLA ? nullptr : A + (m0 + ra) * a_sr + ka;
  const int64_t b_left = N - (n0 + nb);
  const int b_bytes = b_left >= 4 ? 16 : b_left > 0 ? 4 * (int)b_left : 0;

  // the f32 operands of the stage at k0 into staging slot r; the edges
  // zero-filled
  auto stage_raw = [&](int64_t k0, int r) {
    float* const Ar = Ar0 + r * BM * KC;
    float* const Br = Br0 + r * NOUT * KC * BN;
    if constexpr (!PLA) {
      if (vec_a) {
        // this thread's chunks: 4 k at ka of rows ra + i * RA
        const int64_t left = K - (k0 + ka);
        const int bytes = left >= 4 ? 16 : left > 0 ? 4 * (int)left : 0;
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const int m = ra + i * RA;
          const bool in = bytes > 0 && m0 + m < M;
          cp_async16(Ar + m * KC + ka, in ? a_row + i * RA * a_sr + k0 : A,
                     in ? bytes : 0);
        }
      } else {
        for (int e = tid; e < BM * KC; e += NT) {
          const int64_t gm = m0 + e / KC, gk = k0 + e % KC;
          const bool in = gm < M && gk < K;
          cp_async4(Ar + e, in ? A + gm * a_sr + gk * a_sc : A, in);
        }
      }
    }
    if constexpr (!PL) {
#pragma unroll
      for (int t = 0; t < NOUT; ++t) {
        float* const dst = Br + t * KC * BN;
        if (vec_b) {
          // this thread's chunks: 4 columns at nb of k rows kb + i * RB
#pragma unroll
          for (int i = 0; i < NB; ++i) {
            const int kk = kb + i * RB;
            const bool in = b_bytes > 0 && k0 + kk < K;
            cp_async16(dst + kk * BN + nb,
                       in ? B[t] + (k0 + kk) * b_sr + n0 + nb : B[t],
                       in ? b_bytes : 0);
          }
        } else {
          for (int e = tid; e < KC * BN; e += NT) {
            const int64_t gk = k0 + e / BN, gn = n0 + e % BN;
            const bool in = gk < K && gn < N;
            cp_async4(dst + e, in ? B[t] + gk * b_sr + gn * b_sc : B[t], in);
          }
        }
      }
    }
  };
  // the stored planes of the stage at k0, as they are, into the planes; the
  // edges and the planes past the stored count zero-filled
  auto stage_planes = [&](int64_t k0) {
    if constexpr (PLA) {
      for (int i = 0; i < nl; ++i) {
        __nv_bfloat16* const dst = As0 + i * BM * AP;
        const __nv_bfloat16* const src = ap.p + i * ap.plane;
        if (vec_a) {
#pragma unroll
          for (int u = 0; u < BM / RA8; ++u) {
            const int64_t gm = m0 + ra8 + u * RA8;
            const bool in = i < nsa && gm < M && k0 + ka8 < K;
            cp_async16(dst + (ra8 + u * RA8) * AP + ka8,
                       in ? src + gm * ap.sr + k0 + ka8 : ap.p, in ? 16 : 0);
          }
        } else {
          for (int e = tid; e < BM * KC; e += NT) {
            const int m = e / KC, kk = e % KC;
            const int64_t gm = m0 + m, gk = k0 + kk;
            dst[m * AP + kk] =
                i < nsa && gm < M && gk < K ? src[gm * ap.sr + gk] : zero;
          }
        }
      }
    }
    if constexpr (PL) {
      for (int j = 0; j < nl; ++j) {
        __nv_bfloat16* const dst = Bs0 + j * KC * BP;
        const __nv_bfloat16* const src = bp.p + j * bp.plane;
        if (vec_b) {
#pragma unroll
          for (int u = 0; u < KC / RB8; ++u) {
            const int kk = kb8 + u * RB8;
            const int64_t gk = k0 + kk;
            const bool in = j < nsb && gk < K && n0 + nb8 < N;
            cp_async16(dst + kk * BP + nb8,
                       in ? src + gk * bp.sr + n0 + nb8 : bp.p, in ? 16 : 0);
          }
        } else {
          for (int e = tid; e < KC * BN; e += NT) {
            const int kk = e / BN, nn = e % BN;
            const int64_t gk = k0 + kk, gn = n0 + nn;
            dst[kk * BP + nn] =
                j < nsb && gk < K && gn < N ? src[gk * bp.sr + gn] : zero;
          }
        }
      }
    }
  };
  // the f32 values of staging slot r limbed into planes buffer b, once for
  // the block; with the 16-byte copies each thread limbs the chunks it
  // copied itself
  auto limb_stage = [&](int r, int b) {
    const float* const Ar = Ar0 + r * BM * KC;
    const float* const Br = Br0 + r * NOUT * KC * BN;
    __nv_bfloat16* const As = As0 + b * PB;
    __nv_bfloat16* const Bs = Bs0 + b * PB;
    if constexpr (!PLA) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int m = ra + i * RA;
        limb4<NL>(Ar + m * KC + ka, As + m * AP + ka, BM * AP, nl);
      }
    }
    if constexpr (!PL) {
#pragma unroll
      for (int t = 0; t < NOUT; ++t)
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int kk = kb + i * RB;
          limb4<NL>(Br + (t * KC + kk) * BN + nb,
                    Bs + (t * NL * KC + kk) * BP + nb, KC * BP, nl);
        }
    }
  };

  // ldmatrix row addresses: A's rows of the warp's fragment mf (threads
  // 16..31 at k + 8); B's k rows of fragments 2p, 2p + 1 (threads 16..31
  // at n + 8)
  const int ar = lane & 15;
  const int ak = (lane >> 4) * 8;
  auto a_at = [&](int i, int mf, int ks) {
    return As0 + cb * PB + (i * BM + wm * WM + mf * 16 + ar) * AP + ks * 16 +
           ak;
  };
  auto b_at = [&](int t, int j, int p, int ks) {
    return Bs0 + cb * PB + ((t * NL + j) * KC + ks * 16 + ar) * BP +
           wn * WN + p * 16 + ak;
  };
  const int64_t stages = (K + KC - 1) / KC;

  if constexpr (DP) {
    if (vec_a && vec_b) {
      // Two plane buffers: in stage s, one warp of each scheduler runs the
      // MMAs of buffer s % 2 while the other limbs stage s + 1 into the
      // other buffer (then they swap tasks), so the CUDA cores' limbing
      // and the tensor cores' MMAs overlap; one barrier per stage.  The
      // copies run RS stages ahead, RS groups in flight, each thread
      // waiting for its own.
      const bool mma_first = (tid >> 5) >= WGM * WGN / 2;
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        if (r < stages) stage_raw(r * KC, r);
        cp_async_commit();
      }
      if (stages > 0) {
        cp_async_wait<RS - 1>();
        limb_stage(0, 0);
        if (RS < stages) stage_raw(RS * KC, 0);
      }
      cp_async_commit();
      __syncthreads();
#pragma unroll 1
      for (int64_t s = 0; s < stages; ++s) {
        cb = (int)(s & 1);
        auto next = [&]() {
          if (s + 1 < stages) {
            cp_async_wait<RS - 1>();
            const int r = (int)((s + 1) % RS);
            limb_stage(r, cb ^ 1);
            if (s + 1 + RS < stages) stage_raw((s + 1 + RS) * KC, r);
          }
          cp_async_commit();
        };
        if (mma_first) {
          chunk_step<NL, NO, NOUT, FM, FN, LN>(acc, nl, mo, rn, ro, a_at,
                                               b_at);
          next();
        } else {
          next();
          chunk_step<NL, NO, NOUT, FM, FN, LN>(acc, nl, mo, rn, ro, a_at,
                                               b_at);
        }
        __syncthreads();  // buffer s % 2 is free, the other one written
      }
      return;
    }
  }

  // One plane buffer: the f32 operands' copies run RS stages ahead (RS
  // groups in flight; a stage's copies and, in the first group, the planes
  // of stage 0 form one group); the stored planes' copies of the next stage
  // start when every warp is done with the planes, so they are waited for
  // with all the rest
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    if (r < stages) {
      stage_raw(r * KC, r);
      if (r == 0) stage_planes(0);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int64_t s = 0; s < stages; ++s) {
    const int r = (int)(s % RS);
    if constexpr (PL || PLA)
      cp_async_wait<0>();
    else
      cp_async_wait<RS - 1>();
    __syncthreads();  // the stage has landed; the planes are free
    if constexpr (!PL || !PLA) {
      limb_stage(r, 0);
      __syncthreads();  // the planes are written; slot r is free
    }
    if (s + RS < stages) stage_raw((s + RS) * KC, r);
    cp_async_commit();
    chunk_step<NL, NO, NOUT, FM, FN, LN>(acc, nl, mo, rn, ro, a_at, b_at);
    if constexpr (PL || PLA) {
      if (s + 1 < stages) {
        __syncthreads();  // every warp is done with the planes
        stage_planes((s + 1) * KC);
        cp_async_commit();
      }
    }
  }
}

// The tile of block blockIdx.x: the blocks walk M first, so that the blocks
// in flight share B's column block (a weight larger than the L2 cache, as
// lm_head's, is then read from device memory about once) and A stays in L2.
template <int BM>
__device__ __forceinline__ int64_t tile_m0(int64_t M) {
  return (int64_t)(blockIdx.x % ((M + BM - 1) / BM)) * BM;
}

template <int BM, int BN>
__device__ __forceinline__ int64_t tile_n0(int64_t M) {
  return (int64_t)(blockIdx.x / ((M + BM - 1) / BM)) * BN;
}

// out(gm, gn, mf, nf, e) for each of this thread's outputs of the
// prefill tile at (m0, n0) that lies inside (M, N)
template <int NL, int NO, int NOUT, int E, typename Out>
__device__ __forceinline__ void tile_outputs(int64_t M, int64_t N, int64_t m0,
                                             int64_t n0, Out out) {
  using T = Tile<NL, NO, NOUT, E>;
  const int lane = threadIdx.x & 31;
  const int wm = (threadIdx.x >> 5) / WGN;
  const int wn = (threadIdx.x >> 5) % WGN;
#pragma unroll
  for (int mf = 0; mf < T::FM; ++mf)
#pragma unroll
    for (int nf = 0; nf < T::FN; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t gm =
            m0 + wm * T::WM + mf * 16 + (lane >> 2) + 8 * (e >> 1);
        const int64_t gn = n0 + wn * T::WN + nf * 8 + 2 * (lane & 3) + (e & 1);
        if (gm < M && gn < N) out(gm, gn, mf, nf, e);
      }
}

// One (BM x BN) tile at (blockIdx.y, blockIdx.x) of C = A @ B at the format,
// B as f32 values or (PL) as stored limb planes, rows at their own lanes
// (LN), A as stored limb planes (PLA): the body of fused_matmul_kernel,
// prelimbed_matmul_kernel, mixed_prelimbed_matmul_kernel and
// both_prelimbed_matmul_kernel, so the four share every add of every output
// element.  PARTS (the partials epilogue): instead of the combine, order o's
// accumulator of each output goes to C[o * c_so + ...], for o <= max_order.
template <int NL, int NO, bool GEN, bool PL, bool LN = false,
          bool PLA = false, bool PARTS = false, int E = tile_e(NL, NO, 1)>
__device__ __forceinline__ void matmul_tile(
    const float* A, int64_t a_sr, int64_t a_sc, const float* B, int64_t b_sr,
    int64_t b_sc, Planes bp, float* C, int64_t c_sr, int64_t c_sc, int64_t M,
    int64_t N, int64_t K, int n_limbs, int max_order,
    const int32_t* ln = nullptr, const int32_t* lo = nullptr,
    Planes ap = Planes{}, int64_t c_so = 0) {
  static_assert(!PARTS || !LN, "the partials epilogue has no lanes");
  using T = Tile<NL, NO, 1, E>;
  const float* const Bt[1] = {B};
  const int64_t m0 = tile_m0<T::BM>(M);
  const int64_t n0 = tile_n0<T::BM, T::BN>(M);
  Acc<NL, NO, 1, E> acc;
  mainloop<NL, NO, 1, GEN, PL, LN, PLA, E>(A, a_sr, a_sc, Bt, b_sr, b_sc, M,
                                           N, K, m0, n0, n_limbs, max_order,
                                           acc, bp, ln, lo, ap);
  const int mo = GEN ? max_order : NO - 1;
  tile_outputs<NL, NO, 1, E>(M, N, m0, n0, [&](int64_t gm, int64_t gn, int mf,
                                               int nf, int e) {
    if constexpr (PARTS) {
#pragma unroll
      for (int o = 0; o < NO; ++o)
        if (o <= mo) C[o * c_so + gm * c_sr + gn * c_sc] = acc[0][o][mf][nf][e];
    } else {
      float per_order[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) per_order[o] = acc[0][o][mf][nf][e];
      // a lane row joins its own orders, from its own highest one down
      C[gm * c_sr + gn * c_sc] =
          combine_orders<NO>(per_order, LN ? lo[gm] : mo);
    }
  });
}

// Port of _fused_kernel: C[z] = A[z] @ B[z] at the format, z over up to two
// batch dims with their own strides (a stride of 0 broadcasts), so decode
// attention's (B, H, 1, Dh) x (B, H, Dh, T) runs as one launch.
//
// PARTS, the partials epilogue (replaces no TPU kernel: the JAX package
// computes the sharded backend's local step, ref.mp_matmul_partials, in
// XLA, core/dispatch.py _sharded_2d).  The same mainloop in the same order;
// at the flush each order's f32 accumulator goes to the (n_orders, M, N)
// stack C + o * c_so instead of through combine_orders, so the K-sharded
// backend reduces the stack across ranks and joins the orders once, after
// the reduce.  At one rank, combine_partials of the stack is this kernel's
// combined output bit for bit (the combine is adds and subtracts, with no
// product for nvcc to contract).  Bound like the kernel itself, plus
// n_orders x M x N x 4 bytes of stores in place of M x N x 4.
template <int NL, int NO, bool GEN, bool PARTS = false>
__global__ void __launch_bounds__(NT) fused_matmul_kernel(MatmulArgs p) {
  const int64_t z = blockIdx.z;
  const int64_t z0 = z / p.nb1;
  const int64_t z1 = z % p.nb1;
  matmul_tile<NL, NO, GEN, false, false, false, PARTS>(
      p.a + z0 * p.a_sb0 + z1 * p.a_sb1, p.a_sr, p.a_sc,
      p.b + z0 * p.b_sb0 + z1 * p.b_sb1, p.b_sr, p.b_sc, Planes{},
      p.c + z0 * p.c_sb0 + z1 * p.c_sb1, p.c_sr, p.c_sc, p.M, p.N, p.K,
      p.n_limbs, p.max_order, nullptr, nullptr, Planes{}, p.c_so);
}


// Port of _prelimbed_kernel (build_prelimbed_call(both=False)): A limbed on
// the fly, B read from its stored limb planes (the serving decode path's
// pre-limbed weights).  Same tiles, same chunks, same per-order accumulators,
// same _combine_orders flush as fused_matmul_kernel: on planes decomposed
// from a raw weight it returns fused_matmul_kernel's result on that weight,
// bit for bit.  Bound at decode (M = 8) by the bytes of the planes it reads
// (an M8 format reads plane 0 only: half the f32 weight's bytes).
template <int NL, int NO, bool GEN>
__global__ void __launch_bounds__(NT) prelimbed_matmul_kernel(PrelimbedArgs p) {
  matmul_tile<NL, NO, GEN, true>(p.a, p.a_sr, 1, nullptr, 0, 0, p.b, p.c,
                                 p.c_sr, 1, p.M, p.N, p.K, p.n_limbs,
                                 p.max_order);
}

// Port of _mixed_prelimbed_kernel (build_mixed_prelimbed_call): the
// pre-limbed kernel at the batch's envelope depth, each output row at its
// own lane format (lane_n[m], lane_ord[m]) at or below the envelope.  The
// MMAs run for every row; a row adds only the terms its lane keeps (the TPU
// kernel adds a masked +0.0 instead), and the flush joins the row's orders
// from its own highest one down, so a row is bit for bit
// prelimbed_matmul_kernel's row at the lane's format, signs of zeros
// included.  One launch serves a decode micro-batch whose slots run
// different formats.  Bound like the pre-limbed kernel at decode (M = 8) by
// the bytes of the planes it reads: the envelope's, once for all rows.
template <int NL, int NO, bool GEN>
__global__ void __launch_bounds__(NT)
    mixed_prelimbed_matmul_kernel(MixedPrelimbedArgs p) {
  matmul_tile<NL, NO, GEN, true, true>(
      p.m.a, p.m.a_sr, 1, nullptr, 0, 0, p.m.b, p.m.c, p.m.c_sr, 1, p.m.M,
      p.m.N, p.m.K, p.m.n_limbs, p.m.max_order, p.lane_n, p.lane_ord);
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
// decompose kernel).  Same tiles, chunks, products, per-order accumulators
// and _combine_orders flush as fused_matmul_kernel, so on planes decomposed
// from f32 operands it returns fused_matmul_kernel's result on them, bit for
// bit.  Bound at the prefill shapes by its limb products (28 for M52): the
// fragment reads from shared memory and the MMAs.  The built-in formats'
// planes a tensor map reads take both_tma_kernel of mp_matmul_hopper.cu
// (the same bits); this tile keeps the rest, at every M.
template <int NL, int NO, bool GEN>
__global__ void __launch_bounds__(NT)
    both_prelimbed_matmul_kernel(BothPrelimbedArgs p) {
  matmul_tile<NL, NO, GEN, true, false, true>(
      nullptr, 0, 0, nullptr, 0, 0, p.b, p.c, p.c_sr, 1, p.M, p.N, p.K,
      p.n_limbs, p.max_order, nullptr, nullptr, p.a);
}

// Port of _decompose_kernel: x (n f32 values) -> n_limbs bf16 planes of n
// values each, the round-to-nearest-even cascade of _extract_limbs (bitwise
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

// Port of _fused_multi_kernel: the A tile is limbed once per K stage and
// feeds every output; proj_store's epilogue runs before the single store.
template <int NL, int NO, int NOUT, bool GEN,
          int E = tile_e(NL, NO, NOUT)>
__global__ void __launch_bounds__(NT) fused_proj_kernel(ProjArgs p) {
  using T = Tile<NL, NO, NOUT, E>;
  const int64_t m0 = tile_m0<T::BM>(p.M);
  const int64_t n0 = tile_n0<T::BM, T::BN>(p.M);
  Acc<NL, NO, NOUT, E> acc;
  mainloop<NL, NO, NOUT, GEN, false, false, false, E>(
      p.a, p.a_sr, 1, p.b, p.b_sr, 1, p.M, p.N, p.K, m0, n0, p.n_limbs,
      p.max_order, acc);
  const int mo = GEN ? p.max_order : NO - 1;
  tile_outputs<NL, NO, NOUT, E>(p.M, p.N, m0, n0, [&](int64_t gm, int64_t gn,
                                                      int mf, int nf, int e) {
    float y[NOUT];
#pragma unroll
    for (int t = 0; t < NOUT; ++t) {
      float per_order[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) per_order[o] = acc[t][o][mf][nf][e];
      y[t] = combine_orders<NO>(per_order, mo);
    }
    proj_store<NOUT>(p, gm, gn, 0, y);
  });
}


// Launch one prefill-tile kernel over (M / BM) x (N / BN) blocks of NT
// threads (x, M first) and the batch (z); its dynamic shared memory limit is
// raised to the tile's need once per kernel.
template <int NL, int NO, int NOUT, bool PL, bool PLA, auto kernel,
          typename Args, int E = tile_e(NL, NO, NOUT)>
cudaError_t launch_tile(const Args& p, int64_t M, int64_t N, int64_t nz,
                        cudaStream_t st) {
  using T = Tile<NL, NO, NOUT, E>;
  constexpr int64_t smem = T::smem(PL, PLA);
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const dim3 grid((unsigned)(((M + T::BM - 1) / T::BM) *
                             ((N + T::BN - 1) / T::BN)),
                  1, (unsigned)nz);
  kernel<<<grid, NT, (size_t)smem, st>>>(p);
  return cudaGetLastError();
}

// The prefill tile's outputs per thread the tuner may ask for: tile_e's
// (the budget where ptxas stopped spilling), or half of it for the built-in
// formats' projection (fewer registers, so no spill; more blocks).  0 where
// E / 2 is not built.
__host__ __device__ constexpr int tile_e_alt(int nl, int no, int nout) {
  return tile_e(nl, no, nout) >= 8 ? tile_e(nl, no, nout) / 2 : 0;
}

// launch_tile at the tuner's E (e_req: 0 or tile_e's for the default,
// tile_e_alt's for the other instantiation, anything else an error)
template <int NL, int NO, int NOUT, bool TUNED, auto kernel, auto kernel_alt,
          typename Args>
cudaError_t launch_tile_tuned(const Args& p, int64_t M, int64_t N, int64_t nz,
                              int e_req, cudaStream_t st) {
  constexpr int E = tile_e(NL, NO, NOUT);
  if (e_req <= 0 || e_req == E)
    return launch_tile<NL, NO, NOUT, false, false, kernel>(p, M, N, nz, st);
  if constexpr (TUNED && tile_e_alt(NL, NO, NOUT) > 0) {
    constexpr int EA = tile_e_alt(NL, NO, NOUT);
    if (e_req == EA)
      return launch_tile<NL, NO, NOUT, false, false, kernel_alt, Args, EA>(
          p, M, N, nz, st);
  }
  return cudaErrorInvalidValue;
}

// The prefill tile of the operands TMA cannot read (a stride-0 broadcast, a
// column stride other than 1, a row stride or base off 16 bytes); the
// decode shapes (M <= DEC_M) and TMA's operands run the kernels of
// mp_matmul_hopper.cu.  Both tiles give every output the same bits.
template <int NL, int NO, bool GEN, bool PARTS = false>
cudaError_t launch_matmul(const MatmulArgs& p, int64_t nb0, cudaStream_t st) {
  if (p.M <= DEC_M) return cudaErrorInvalidValue;
  return launch_tile<NL, NO, 1, false, false,
                     fused_matmul_kernel<NL, NO, GEN, PARTS>>(
      p, p.M, p.N, nb0 * p.nb1, st);
}

// the tile choice is launch_matmul's, so the two kernels tile alike; the
// decode shapes (M <= DEC_M) take mp_matmul_hopper.cu's split tile
template <int NL, int NO, bool GEN>
cudaError_t launch_prelimbed(const PrelimbedArgs& p, cudaStream_t st) {
  if (p.M <= DEC_M) return cudaErrorInvalidValue;
  return launch_tile<NL, NO, 1, true, false,
                     prelimbed_matmul_kernel<NL, NO, GEN>>(p, p.M, p.N, 1, st);
}

template <int NL, int NO, bool GEN>
cudaError_t launch_mixed_prelimbed(const MixedPrelimbedArgs& p,
                                   cudaStream_t st) {
  if (p.m.M <= DEC_M) return cudaErrorInvalidValue;
  return launch_tile<NL, NO, 1, true, false,
                     mixed_prelimbed_matmul_kernel<NL, NO, GEN>>(p, p.m.M,
                                                                 p.m.N, 1, st);
}

template <int NL, int NO, bool GEN>
cudaError_t launch_both_prelimbed(const BothPrelimbedArgs& p,
                                  cudaStream_t st) {
  return launch_tile<NL, NO, 1, true, true,
                     both_prelimbed_matmul_kernel<NL, NO, GEN>>(p, p.M, p.N, 1,
                                                                st);
}

// the decode shapes (M <= DEC_M) take mp_matmul_hopper.cu's split tile
template <int NL, int NO, int NOUT, bool GEN>
cudaError_t launch_proj(const ProjArgs& p, int e, cudaStream_t st) {
  if (p.M <= DEC_M) return cudaErrorInvalidValue;
  constexpr int EA = !GEN && tile_e_alt(NL, NO, NOUT)
                         ? tile_e_alt(NL, NO, NOUT)
                         : tile_e(NL, NO, NOUT);
  return launch_tile_tuned<NL, NO, NOUT, !GEN,
                           fused_proj_kernel<NL, NO, NOUT, GEN>,
                           fused_proj_kernel<NL, NO, NOUT, GEN, EA>>(
      p, p.M, p.N, 1, e, st);
}

template <int NOUT>
cudaError_t proj_for_format(const ProjArgs& p, int e, cudaStream_t st) {
  const int nl = p.n_limbs;
  const int mo = p.max_order;
  if (nl == 1 && mo == 0) return launch_proj<1, 1, NOUT, false>(p, e, st);
  if (nl == 2 && mo == 1) return launch_proj<2, 2, NOUT, false>(p, e, st);
  if (nl == 3 && mo == 2) return launch_proj<3, 3, NOUT, false>(p, e, st);
  if (nl == 5 && mo == 4) return launch_proj<5, 5, NOUT, false>(p, e, st);
  if (nl == 7 && mo == 6) return launch_proj<7, 7, NOUT, false>(p, e, st);
  return launch_proj<GEN_NL, GEN_NO, NOUT, true>(p, e, st);
}

}  // namespace

extern "C" {

// The K of one chunk (KC): the length of every MMA chain, so the order of
// every sum these kernels take.
int mp_chunk_k() { return KC; }

// The prefill tile's default outputs per thread for a format's (n_limbs,
// max_order) and n_out weights, and the projection's other choice for the
// tuner (0 where none is built; the generic instantiation has none).
int mp_tile_e(int64_t n_limbs, int64_t max_order, int64_t n_out) {
  return builtin_format(n_limbs, max_order)
             ? tile_e((int)n_limbs, (int)max_order + 1, (int)n_out)
             : tile_e(GEN_NL, GEN_NO, (int)n_out);
}

int mp_tile_e_alt(int64_t n_limbs, int64_t max_order, int64_t n_out) {
  return builtin_format(n_limbs, max_order)
             ? tile_e_alt((int)n_limbs, (int)max_order + 1, (int)n_out)
             : 0;
}

// Dynamic shared memory of one prefill-tile block (Tile::smem) at nl limbs,
// nout weights, e outputs per thread, B as planes (pl), A as planes (pla).
int64_t mp_tile_smem_bytes(int64_t nl, int64_t nout, int64_t e, int64_t pl,
                           int64_t pla) {
  return tile_smem_bytes((int)nl, (int)nout, (int)e, pl != 0, pla != 0);
}

// Dynamic shared memory of one decode-tile block (dec_smem_bytes) at M rows,
// dk k per stage and slots ring slots; and the ring's most k per stage for
// a format's instantiation (DecRing<NL>::K).
int64_t mp_decode_smem_bytes(int64_t pl, int64_t nl, int64_t M, int64_t dk,
                             int64_t slots, int64_t nout) {
  return dec_smem_bytes(pl != 0, (int)nl, (int)M, (int)dk, (int)slots,
                        (int)nout);
}

int mp_decode_ring_k(int64_t n_limbs, int64_t max_order) {
  return builtin_format(n_limbs, max_order) && n_limbs <= 3
             ? DecRing<1>::K
             : DecRing<GEN_NL>::K;
}

// C[z] (M, N) = A[z] (M, K) @ B[z] (K, N) at (n_limbs, max_order); strides in
// elements; z = z0 * nb1 + z1 over nb0 * nb1 batches; M > DEC_M (the decode
// shapes take mp_hopper_matmul_launch).  Returns the CUDA error of the
// launch (0 on success).  Allocates nothing and does not synchronise.
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

// The partials epilogue of mp_fused_matmul_launch: C (max_order + 1, M, N)
// with C[o] the order-o sum of A (M, K) @ B (K, N) at (n_limbs, max_order),
// uncombined; strides in elements (c_so: one order's plane); M > DEC_M.
// Returns the CUDA error of the launch (0 on success).
int mp_fused_matmul_partials_launch(const void* a, int64_t a_sr, int64_t a_sc,
                                    const void* b, int64_t b_sr, int64_t b_sc,
                                    void* c, int64_t c_so, int64_t c_sr,
                                    int64_t c_sc, int64_t M, int64_t N,
                                    int64_t K, int64_t n_limbs,
                                    int64_t max_order, void* stream) {
  if (!format_ok(n_limbs, max_order)) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  MatmulArgs p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<float*>(c), 0, 0, a_sr, a_sc, 0, 0, b_sr, b_sc,
               0, 0, c_sr, c_sc, 1, M, N, K, (int)n_limbs, (int)max_order,
               c_so};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nl = (int)n_limbs;
  const int mo = (int)max_order;
  cudaError_t err;
  if (nl == 1 && mo == 0) err = launch_matmul<1, 1, false, true>(p, 1, st);
  else if (nl == 2 && mo == 1) err = launch_matmul<2, 2, false, true>(p, 1, st);
  else if (nl == 3 && mo == 2) err = launch_matmul<3, 3, false, true>(p, 1, st);
  else if (nl == 5 && mo == 4) err = launch_matmul<5, 5, false, true>(p, 1, st);
  else if (nl == 7 && mo == 6) err = launch_matmul<7, 7, false, true>(p, 1, st);
  else err = launch_matmul<GEN_NL, GEN_NO, true, true>(p, 1, st);
  return (int)err;
}

// out = epilogue(A @ B_t for t < n_out) at (n_limbs, max_order) on the
// strided prefill tile (M > DEC_M; the decode shapes take
// mp_hopper_proj_decode_launch).  A (M, K) and each B_t (K, N) have column
// stride 1 and the given row strides; biases are n_out (N,) vectors or all
// null; res (M, N) or null; gate 1 = swiglu (n_out must be 2, out (M, N)),
// else out is (n_out, M, N) contiguous.  The autotuner's launch parameter,
// 0 for the default choice: tile_e, the prefill tile's outputs per thread
// (mp_tile_e's or mp_tile_e_alt's); dec_dk must be 0 (the decode tile's
// parameter, which older versions of this entry took here).  Parameters a
// launch cannot take return cudaErrorInvalidValue.  No bit of any output
// depends on them.
int mp_fused_proj_launch(const void* a, int64_t a_sr, const void* b0,
                         const void* b1, const void* b2, int64_t b_sr,
                         const void* bias0, const void* bias1,
                         const void* bias2, const void* res, int64_t res_sr,
                         void* out, int64_t n_out, int64_t gate, int64_t M,
                         int64_t N, int64_t K, int64_t n_limbs,
                         int64_t max_order, int64_t dec_dk, int64_t tile_e,
                         void* stream) {
  if (!format_ok(n_limbs, max_order) || n_out < 1 || n_out > MAX_OUT ||
      (gate && n_out != 2) || (res != nullptr && !gate && n_out != 1) ||
      dec_dk != 0)
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
  const int e = tile_e > 0 ? (int)tile_e : 0;
  if (n_out == 1) err = proj_for_format<1>(p, e, st);
  else if (n_out == 2) err = proj_for_format<2>(p, e, st);
  else err = proj_for_format<3>(p, e, st);
  return (int)err;
}

// C (M, N) = A (M, K) @ B at (n_limbs, max_order), B given as n_stored bf16
// limb planes (plane stride b_plane, row stride b_sr; column strides of A,
// the planes and C are 1); M > DEC_M (the decode shapes take
// mp_hopper_prelimbed_launch).  Planes at or past min(n_stored, n_limbs)
// are never read.  Returns the CUDA error of the launch (0 on success).
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
// lane_ord (M,) int32 on the device; M > DEC_M (the decode shapes take
// mp_hopper_mixed_prelimbed_launch).  Planes at or past min(n_stored,
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
