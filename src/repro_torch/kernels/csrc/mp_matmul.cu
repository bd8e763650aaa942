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
// What bounds them on this card, and what the design does about it: the
// decode shapes (M = 8 rows against a 768 x 2304 weight) are bound by the
// bytes of the weight; the prefill shapes (M = 2048) are bound by the limb
// products.  This first version multiplies bf16-rounded limbs with f32 FMAs
// on the CUDA cores (a bf16 x bf16 product is exact in f32, so each FMA adds
// the exact product): every operand element is read from device memory once
// per tile, limbed once in registers as it is loaded, and kept in shared
// memory as bf16 limb planes that all threads of the block reuse.  The
// multi-output kernel limbs its A tile once for all n_out weights.  Ragged
// edges are masked in the loads and stores; nothing is padded in device
// memory.  Tensor-core MMA (mma.sync / wgmma) and TMA are later work.
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

// Port of _fused_multi_kernel: the A tile is limbed once per K step and feeds
// every output; the epilogue runs before the single store, in _flush's order:
// bias, then silu(out0) * out1 (silu(x) = x / (1 + expf(-x)) in f32), then
// the residual.
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
        if (p.bias[0] != nullptr) y[t] = y[t] + p.bias[t][gn];
      }
      if (p.gate) {
        float g = 0.f;
        if constexpr (NOUT == 2) g = (y[0] / (1.0f + expf(-y[0]))) * y[1];
        if (p.res != nullptr) g = g + p.res[gm * p.res_sr + gn];
        p.out[gm * p.N + gn] = g;
      } else {
        if (p.res != nullptr) y[0] = y[0] + p.res[gm * p.res_sr + gn];
#pragma unroll
        for (int t = 0; t < NOUT; ++t) p.out[(t * p.M + gm) * p.N + gn] = y[t];
      }
    }
  }
}

// micro-tile per thread: 4 x 4 while the accumulators stay within ~112
// registers, else 2 x 2 (the generic instantiation, wide fused groups)
constexpr int micro(int no, int nout, bool gen) {
  return (!gen && no * nout <= 7) ? 4 : 2;
}

template <int NL, int NO, bool GEN>
cudaError_t launch_matmul(const MatmulArgs& p, int64_t nb0, cudaStream_t st) {
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
  constexpr int R = micro(NO, 1, GEN);
  const dim3 grid((unsigned)((p.N + TX * R - 1) / (TX * R)),
                  (unsigned)((p.M + TY * R - 1) / (TY * R)), 1);
  prelimbed_matmul_kernel<NL, NO, R, R, GEN><<<grid, NT, 0, st>>>(p);
  return cudaGetLastError();
}

template <int NL, int NO, bool GEN>
cudaError_t launch_mixed_prelimbed(const MixedPrelimbedArgs& p,
                                   cudaStream_t st) {
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

template <int NL, int NO, int NOUT, bool GEN>
cudaError_t launch_proj(const ProjArgs& p, cudaStream_t st) {
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
