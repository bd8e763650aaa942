// The pieces the limb matmul sources share (mp_matmul.cu, mp_matmul_hopper.cu):
// the order contract's tensor-core step (chunk_step), the limb cascade,
// the compensated combine, the projection's epilogue (proj_store), the
// mbarrier and TMA helpers, and the decode tile with its launch.  The
// order of every add is described at the top of mp_matmul.cu.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 64;            // K of one chunk: a chain of KC / 16 MMAs
constexpr int KS = KC / 16;       // k16 steps of one chunk
constexpr int PADE = 8;           // bf16 elements padding each plane row
constexpr int MAX_OUT = 3;        // weights per fused projection launch
constexpr int PAD_N = 1;          // lane of a row past M (lanes.PAD_LANE)
constexpr int PAD_ORD = 0;
constexpr int64_t SMEM_MAX = 232448;  // shared memory one block can use

// Largest limb count and order count of the generic (any registered format)
// instantiation; the built-in formats get their own instantiations.
constexpr int GEN_NL = 8;
constexpr int GEN_NO = 2 * GEN_NL - 1;

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// limbs of 4 f32 values into nl bf16 planes (8-byte aligned, plane stride
// ``ps`` elements): the cascade of _extract_limbs (l0 = bf16(x), l1 =
// bf16(x - l0), ...) on each value, two values per conversion
// (cvt.rn.bf16x2.f32 rounds each as __float2bfloat16_rn does)
template <int NL>
__device__ __forceinline__ void limb4v(float4 x, __nv_bfloat16* dst,
                                       int64_t ps, int nl) {
  float2 r0 = make_float2(x.x, x.y), r1 = make_float2(x.z, x.w);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    if (i >= nl) break;
    const __nv_bfloat162 l0 = __floats2bfloat162_rn(r0.x, r0.y);
    const __nv_bfloat162 l1 = __floats2bfloat162_rn(r1.x, r1.y);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&l0);
    w.y = *reinterpret_cast<const uint32_t*>(&l1);
    *reinterpret_cast<uint2*>(dst + i * ps) = w;
    if (i + 1 < NL) {
      const float2 f0 = __bfloat1622float2(l0), f1 = __bfloat1622float2(l1);
      r0 = make_float2(r0.x - f0.x, r0.y - f0.y);
      r1 = make_float2(r1.x - f1.x, r1.y - f1.y);
    }
  }
}

// the same on 4 f32 values read from src (16-byte aligned); values at or
// past ``nv`` count as +0.0 and are not read
template <int NL>
__device__ __forceinline__ void limb4(const float* src, __nv_bfloat16* dst,
                                      int64_t ps, int nl, int nv = 4) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (nv >= 4) {
    x = *reinterpret_cast<const float4*>(src);
  } else {
    if (nv > 0) x.x = src[0];
    if (nv > 1) x.y = src[1];
    if (nv > 2) x.z = src[2];
  }
  limb4v<NL>(x, dst, ps, nl);
}

// wait for the phase of ``parity`` of an mbarrier; a wait of about ten
// seconds traps, so a stalled pipeline fails its launch instead of holding
// the card
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// a barrier whose phase completes after n arrivals
__device__ __forceinline__ void mbar_init(uint64_t* bar, int n = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(n));
}

// one arrival on bar
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the phase of bar completes when ``bytes`` have landed (one arrival)
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// one box of a 3-d tensor map (c0 innermost) into dst, completing bar
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// The tensor-core step both tiles share.

// four 8x8 bf16 matrices from shared memory (one row address per thread)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed (B stored k-major, read as columns)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d (16 x 8, f32) = a (16 x 16, bf16) @ b (16 x 8, bf16) + +0.0
__device__ __forceinline__ void mma_bf16_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d (16 x 8, f32) += a (16 x 16, bf16) @ b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One chunk (KC k) of the shared order for a warp's FM x FN fragments of
// 16 x 8 outputs, for NOUT weights: for each order o, acc[t][o] += the sum,
// in the format's product order, of the kept products' MMA chains (the
// order described at the top of this file).  a_at(i, mf, ks): this thread's
// ldmatrix row address of A's limb i, m fragment mf, k16 step ks; b_at(t, j,
// p, ks): of weight t's limb j, n fragments 2p and 2p + 1 (FN == 1: n
// fragment 0 only).  Accumulator element e of a fragment is row lane / 4 +
// 8 (e / 2), column 2 (lane % 4) + e % 2.  LN: rn/ro hold the lanes of the
// thread's rows (fragment mf, half e / 2).  Every ldmatrix and MMA runs on
// the whole warp; only the adds are selected per row.
template <int NL, int NO, int NOUT, int FM, int FN, bool LN, typename AAt,
          typename BAt>
__device__ __forceinline__ void chunk_step(
    float (&acc)[NOUT][NO][FM][FN][4], int nl, int mo, const int (&rn)[FM][2],
    const int (&ro)[FM][2], AAt a_at, BAt b_at) {
  // the fragments of A's limb i and of weight t's limb j at k16 step ks
  auto load_a = [&](uint32_t (&a)[FM][4], int i, int ks) {
#pragma unroll
    for (int mf = 0; mf < FM; ++mf) ldsm_x4(a[mf], a_at(i, mf, ks));
  };
  auto load_b = [&](uint32_t (&b)[FN][2], int t, int j, int ks) {
    if constexpr (FN == 1) {
      ldsm_x2_t(b[0], b_at(t, j, 0, ks));
    } else {
#pragma unroll
      for (int p = 0; p < FN / 2; ++p) {
        uint32_t r[4];
        ldsm_x4_t(r, b_at(t, j, p, ks));
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
    }
  };
  // one k16 step of a product's chain (the first one starts from +0.0)
  auto mma_step = [&](float (&f)[FM][FN][4], const uint32_t (&a)[FM][4],
                      const uint32_t (&b)[FN][2], int ks) {
#pragma unroll
    for (int mf = 0; mf < FM; ++mf)
#pragma unroll
      for (int nf = 0; nf < FN; ++nf) {
        if (ks == 0)
          mma_bf16_first(f[mf][nf], a[mf], b[nf][0], b[nf][1]);
        else
          mma_bf16(f[mf][nf], a[mf], b[nf][0], b[nf][1]);
      }
  };
  // the term of product (i, j) in its order's sum: the first kept term,
  // then IEEE adds; LN: only the rows whose lane keeps (i, j)
  auto add_term = [&](float (&tot)[FM][FN][4], bool (&st)[FM][2], bool any,
                      const float (&f)[FM][FN][4], int i, int j) {
#pragma unroll
    for (int mf = 0; mf < FM; ++mf) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bool keep = true, started = any;
        if constexpr (LN) {
          // the row's own order cut (ref.lane_keep)
          keep = i < rn[mf][h] && j < rn[mf][h] && i + j <= ro[mf][h];
          started = st[mf][h];
          st[mf][h] = started || keep;
        }
        if (!keep) continue;
#pragma unroll
        for (int nf = 0; nf < FN; ++nf)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e)
            tot[mf][nf][e] =
                started ? tot[mf][nf][e] + f[mf][nf][e] : f[mf][nf][e];
      }
    }
  };
  // acc[t][o] += the order's sum (LN: in the rows where it started)
  auto add_order = [&](int t, int o, const float (&tot)[FM][FN][4],
                       const bool (&st)[FM][2]) {
#pragma unroll
    for (int mf = 0; mf < FM; ++mf)
#pragma unroll
      for (int nf = 0; nf < FN; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!LN || st[mf][e >> 1])
            acc[t][o][mf][nf][e] = acc[t][o][mf][nf][e] + tot[mf][nf][e];
  };

  if constexpr (NL <= 2 && !LN) {
    // one and two limbs (built-in formats only; not the lane kernels, whose
    // row selection leaves no registers for it): every kept product's chain
    // in one pass over the chunk's k16 steps, so that each limb's fragments
    // are read once per step; each chain is the same MMAs as on its own
#pragma unroll
    for (int t = 0; t < NOUT; ++t) {
      float f[NL][NL][FM][FN][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[NL][FM][4], b[NL][FN][2];
#pragma unroll
        for (int i = 0; i < NL; ++i) load_a(a[i], i, ks);
#pragma unroll
        for (int j = 0; j < NL; ++j) load_b(b[j], t, j, ks);
#pragma unroll
        for (int i = 0; i < NL; ++i)
#pragma unroll
          for (int j = 0; j < NL; ++j)
            if (i + j <= mo) mma_step(f[i][j], a[i], b[j], ks);
      }
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        float tot[FM][FN][4];
        bool st[FM][2] = {};
        bool any = false;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int j = o - i;
          if (j < 0 || j >= NL) continue;
          add_term(tot, st, any, f[i][j], i, j);
          any = true;
        }
        if (any) add_order(t, o, tot, st);
      }
    }
  } else {
    // one product's chain at a time, the terms of an order in turn (with
    // three limbs or more ptxas would otherwise overlap the chains of an
    // order's terms and spill)
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      if (o > mo) continue;
#pragma unroll
      for (int t = 0; t < NOUT; ++t) {
        float tot[FM][FN][4];
        bool st[FM][2] = {};
        bool any = false;
        const int i0 = o - nl + 1 > 0 ? o - nl + 1 : 0;
        const int i1 = o < nl - 1 ? o : nl - 1;
#pragma unroll 1
        for (int i = i0; i <= i1; ++i) {
          float f[FM][FN][4];
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t a[FM][4], b[FN][2];
            load_a(a, i, ks);
            load_b(b, t, o - i, ks);
            mma_step(f, a, b, ks);
          }
          add_term(tot, st, any, f, i, o - i);
          any = true;
        }
        if (any) add_order(t, o, tot, st);
      }
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
// residual.  Every projection tile calls it, so an output has the same bits
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

struct PrelimbedArgs {
  const float* a;        // (M, K), column stride 1
  Planes b;              // (L, K, N) limb planes, column stride 1
  float* c;              // (M, N), column stride 1
  int64_t a_sr, c_sr;
  int64_t M, N, K;
  int n_limbs, max_order;
};

// the mixed-lane matmul's: the pre-limbed arguments at the envelope, and
// each row's lane
struct MixedPrelimbedArgs {
  PrelimbedArgs m;          // the envelope's (n_limbs, max_order) in m
  const int32_t* lane_n;    // (M,) limbs of each row's lane
  const int32_t* lane_ord;  // (M,) order cut of each row's lane
};

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
  int64_t c_so;  // PARTS: stride of one order's (M, N) plane of C
};

// ---------------------------------------------------------------------------
// The decode tile: the body of every limb matmul's decode kernels (M <=
// DEC_M: a decode micro-batch of 1..16 rows, or one row per batch entry of
// decode attention's QK and PV), single-block or split over a cluster
// (mp_matmul_hopper.cu).
//
// Invariant: every output element gets exactly the MMAs and adds of the
// prefill tile, in the same order (chunk_step on the same chunks of KC k,
// from k = 0), so a row has the same bits whichever tile ran it, and
// pre-limbed == fused, mixed rows == homogeneous rows and scheduled == solo
// keep holding.  The M rows fill one m16 fragment: rows M..15 read 16 zero
// bytes and are never stored, and an MMA's rows do not interact.  k per
// ring stage is a multiple of KC, so a chunk never straddles two stages;
// the last stage's chunk is zero-filled past K, in the planes, as the
// prefill tile's is.  LN: a row at its own lane skips the terms its lane
// leaves out and joins its orders from its own cut down, as chunk_step and
// matmul_tile do.  NOUT weights: each weight's sums are its own, as the
// prefill tile's per-weight accumulators.
//
// Design: the block owns DEC_N columns and all M rows; two compute warps,
// one per 8 columns (one n8 fragment), carry NOUT x NO accumulators of 4
// outputs per thread.  Two or four producer warps (warp specialisation)
// stream A and the NOUT Bs through a ring of DecRing::S stages of up to
// DecRing::K k each in dynamic shared memory, by cp.async (16-byte
// cp.async.cg where the rows are contiguous and 16-byte aligned, else
// element by element), and limb stage s + 1 (A's rows, once for every
// weight; the f32 Bs too) into bf16 planes, once per block, while the
// compute warps run stage s from the other of two plane buffers: one block
// barrier per stage.  A's plane rows are padded by PADE and B's 8-column
// halves swap places every 4 k rows, so ldmatrix reads both without bank
// conflicts.
constexpr int DEC_M = 16;   // most rows of the decode tile
constexpr int DEC_N = 16;   // columns of one block
constexpr int DEC_CT = 64;  // compute threads: one warp per 8 columns

// ring shape per limb count: deeper formats do more products per byte
template <int NL>
struct DecRing {
  static constexpr int K = NL <= 3 ? 256 : 128;  // most k of one stage
  static constexpr int S = 3;                    // stages
  // producer warps: the fused kernels limb their B stages as well
  static constexpr int P(bool pl) { return pl ? 2 : 4; }
};

// column of B plane row k where column c (of DEC_N) is kept
__device__ __forceinline__ int dec_col(int k, int c) {
  return c ^ (((k >> 2) & 1) << 3);
}

// dynamic shared memory of the decode tile: the B ring (bf16 planes, or f32
// for each of nout weights), the A ring (f32), A's limb planes (rows padded
// by PADE) and (fused) the Bs' limb planes, two buffers each, then 16 zero
// bytes (the fragment's rows past M); every region a multiple of 16 bytes
// (dk is a multiple of KC)
__host__ __device__ inline int64_t dec_ring_b_bytes(bool pl, int nl, int dk,
                                                    int slots, int nout) {
  return pl ? (int64_t)slots * nl * dk * DEC_N * 2
            : (int64_t)nout * slots * dk * DEC_N * 4;
}

__host__ __device__ inline int64_t dec_smem_bytes(bool pl, int nl, int M,
                                                  int dk, int slots,
                                                  int nout) {
  return dec_ring_b_bytes(pl, nl, dk, slots, nout) +
         (int64_t)slots * M * dk * 4 + 2 * (int64_t)nl * M * (dk + PADE) * 2 +
         (pl ? 0 : 2 * (int64_t)nout * nl * dk * DEC_N * 2) + 16;
}

// The split tile on stored planes (PL and SPLIT) fills its B ring by TMA:
// the ring's mbarriers take the first 64 bytes, the regions start at the
// next 1024-byte boundary (the 32-byte swizzle's pattern follows address
// bits), so the block asks for DEC_TMA_SLACK bytes more
constexpr int DEC_TMA_SLACK = 64 + 1024;
constexpr int DEC_TMA_ALIGN = 1024;

__host__ __device__ inline int64_t dec_split_bytes(bool pl, int nl, int M,
                                                   int dk, int slots,
                                                   int nout) {
  return dec_smem_bytes(pl, nl, M, dk, slots, nout) +
         (pl ? DEC_TMA_SLACK : 0);
}

// dk: k per ring stage (a multiple of KC, at most DecRing<NL>::K); the
// dynamic shared memory holds dec_smem_bytes(PL, nl, M, dk, slots, NOUT)
// bytes, slots = min(DecRing<NL>::S, stages).  Warp roles: the first
// DEC_CT threads own the outputs; the DecRing<NL>::P(PL) warps after them
// copy and limb.  B: NOUT f32 weights (PL: unused, NOUT == 1, the planes
// bp instead); LN: row r's lane is (ln[r], lo[r]).  The row's NOUT results
// go to store(r, column, y) after combine_orders; PARTS (the partials
// epilogue, NOUT == 1): its NO per-order accumulators go to store(r,
// column, per_order) instead, uncombined.  n0: the block's first column.
// SPLIT (the cluster-split decode tile of mp_matmul_hopper.cu, any NOUT,
// lanes or none): the block runs a range of K's chunks and stores each
// chunk's per-order sums of weight t, tot_c[t][o] = +0.0 + tot (LN: +0.0
// in the rows whose lane keeps no term of o), to tots[((c * NOUT + t) * NO
// + o) * DEC_M * DEC_N + row * DEC_N + column] (c counted from the range's
// first chunk) instead of adding them up; nothing is stored through
// ``store``.  With stored planes (PL and SPLIT: dec_split_bytes of shared
// memory) the first producer thread fills the B ring by TMA from ``bmap``
// (a 3-d map of the planes: columns, k, plane; a box of DEC_N columns by
// dk k in the 32-byte swizzle, which lays each k row's two 8-column halves
// as dec_col does), k counted from ``bmap_k0``; each ring slot completes
// an mbarrier the compute warps wait on.  The TMA fills zeros past N and
// K, the chunk edge of the contract.
template <int NL, int NO, bool GEN, bool PL, bool LN = false, int NOUT = 1,
          bool PARTS = false, bool SPLIT = false, typename Store>
__device__ __forceinline__ void decode_tile(
    const float* __restrict__ A, int64_t a_sr, int64_t a_sc,
    const float* const (&B)[NOUT], int64_t b_sr, int64_t b_sc, Planes bp,
    int M, int64_t N, int64_t K, int n_limbs, int max_order, int dk,
    const int32_t* __restrict__ ln, const int32_t* __restrict__ lo,
    Store store, int64_t n0, float* __restrict__ tots = nullptr,
    const CUtensorMap* bmap = nullptr, int bmap_k0 = 0) {
  static_assert(!PL || NOUT == 1, "stored planes come for one weight");
  static_assert(!SPLIT || !PARTS, "the split kernel joins the partials");
  constexpr bool TMAB = PL && SPLIT;   // the B ring filled by TMA
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
  const int ring = M * dk;         // f32 elements of one A ring slot
  const int ap = dk + PADE;        // elements of one A plane row
  const int plane = M * ap;        // elements of one A limb plane
  // TMAB: the ring's mbarriers first, the regions from the next 1024-byte
  // boundary
  uint64_t* const full = reinterpret_cast<uint64_t*>(dec_smem);
  unsigned char* const base =
      TMAB ? reinterpret_cast<unsigned char*>(
                 (reinterpret_cast<uintptr_t>(dec_smem) + 64 + DEC_TMA_ALIGN -
                  1) &
                 ~(uintptr_t)(DEC_TMA_ALIGN - 1))
           : dec_smem;
  // regions: the B ring, the A ring, A's limb planes (two buffers), the
  // Bs' limb planes (fused, two buffers each), zeros
  __nv_bfloat16* const Bp = reinterpret_cast<__nv_bfloat16*>(base);
  float* const Br = reinterpret_cast<float*>(base);
  float* const Ar = reinterpret_cast<float*>(
      base + dec_ring_b_bytes(PL, nl, dk, slots, NOUT));
  __nv_bfloat16* const As =
      reinterpret_cast<__nv_bfloat16*>(Ar + (int64_t)slots * ring);
  __nv_bfloat16* const Bl = As + 2 * nl * plane;
  __nv_bfloat16* const zeros = Bl + (PL ? 0 : 2 * NOUT * nl * dk * DEC_N);
  auto bp_at = [&](int q, int j) { return (q * nl + j) * dk * DEC_N; };
  auto br_at = [&](int q, int t) { return (q * NOUT + t) * dk * DEC_N; };
  auto as_at = [&](int buf, int i) { return (buf * nl + i) * plane; };
  auto bl_at = [&](int buf, int t, int j) {
    return ((buf * NOUT + t) * nl + j) * dk * DEC_N;
  };

  const int tid = threadIdx.x;
  const bool producer = tid >= DEC_CT;
  const int pt = tid - DEC_CT;  // producer thread index
  const int np = (int)blockDim.x - DEC_CT;
  const int nst = PL ? (bp.n_stored < nl ? bp.n_stored : nl) : nl;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  auto stage_k = [&](int s) {
    const int64_t left = K - (int64_t)s * dk;
    return left < dk ? (int)left : dk;
  };

  // producers: stage s of A and B into ring slot s % NS, A's and the f32
  // Bs' valid k, the stored planes up to the stage's last chunk (zeros past
  // K); index maps by shifts and masks (DEC_N is 16), neighbouring threads
  // on neighbouring addresses where the layout allows
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
          cp_async16(Ar + q * ring + m * dk + 4 * e, A + m * a_sr + k0 + 4 * e,
                     left < 4 ? 4 * left : 16);
        }
    } else {
      for (int m = 0; m < M; ++m)
        for (int kk = pt; kk < kn; kk += np)
          cp_async4(Ar + q * ring + m * dk + kk,
                    A + m * a_sr + (k0 + kk) * a_sc, true);
    }
    if constexpr (TMAB) {
      // the stored planes' boxes of DEC_N columns by dk k, all at once
      if (pt == 0) {
        mbar_expect(full + q, nst * dk * DEC_N * 2);
        for (int j = 0; j < nst; ++j)
          tma_load3(Bp + bp_at(q, j), bmap, (int)n0, bmap_k0 + (int)k0, j,
                    full + q);
      }
    } else if constexpr (PL) {
      const int kc = (kn + KC - 1) / KC * KC;
      for (int j = 0; j < nst; ++j) {
        const __nv_bfloat16* src = bp.p + j * bp.plane + k0 * bp.sr;
        __nv_bfloat16* dst = Bp + bp_at(q, j);
        if (vec_b) {
          // 16-byte chunks: two per plane row of 16 columns
          for (int e = pt; e < kc * 2; e += np) {
            const int kk = e >> 1;
            const int cc = (e & 1) * 8;
            const bool in = kk < kn && n0 + cc < N;
            cp_async16(dst + kk * DEC_N + dec_col(kk, cc),
                       in ? src + kk * bp.sr + n0 + cc : bp.p, in ? 16 : 0);
          }
        } else {
          for (int e = pt; e < kc * DEC_N; e += np) {
            const int kk = e >> 4;
            const int64_t gn = n0 + (e & 15);
            dst[kk * DEC_N + dec_col(kk, e & 15)] =
                kk < kn && gn < N ? src[kk * bp.sr + gn] : zero;
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
  // buffer s % 2, up to the stage's last chunk; the ring's k past the
  // stage's kn (zeros or stale values) are not read: their limbs are +0.0
  auto limb = [&](int s) {
    cp_async_wait<NS - 2>();
    asm volatile("bar.sync 1, %0;\n" ::"r"(np));  // every copy has landed
    const int q = s % NS;
    const int kn = stage_k(s);
    const int kc = (kn + KC - 1) / KC * KC;
    const int buf = s & 1;
    // 4 k of one row (A) or 4 columns of one k (B) at a time
    const int ach = kc >> 2;
    for (int e = pt; e < M * ach; e += np) {
      const int m = e / ach;
      const int kk = (e - m * ach) * 4;
      const int nv = kn - kk;
      limb4<NL>(Ar + q * ring + m * dk + kk, As + as_at(buf, 0) + m * ap + kk,
                plane, nl, nv < 0 ? 0 : nv);
    }
    if constexpr (!PL) {
#pragma unroll
      for (int t = 0; t < NOUT; ++t)
        for (int e = pt; e < kc * 4; e += np) {
          const int kk = e >> 2;
          const int cc = (e & 3) * 4;
          limb4<NL>(Br + br_at(q, t) + 4 * e,
                    Bl + bl_at(buf, t, 0) + kk * DEC_N + dec_col(kk, cc),
                    dk * DEC_N, nl, kk < kn ? 4 : 0);
        }
    }
  };

  // the compute warps: warp w owns columns 8 w .. 8 w + 7; thread's rows
  // g and g + 8 of the fragment
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int g = lane >> 2;
  float acc[NOUT][NO][1][1][4];
#pragma unroll
  for (int t = 0; t < NOUT; ++t)
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][o][0][0][e] = 0.f;
  // the rows' lanes, in registers for the whole K loop (LN only)
  int rn[1][2], ro[1][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    rn[0][h] = LN && !producer && r < M ? ln[r] : PAD_N;
    ro[0][h] = LN && !producer && r < M ? lo[r] : PAD_ORD;
  }

  if constexpr (TMAB) {
    if (tid == DEC_CT) {
      for (int q = 0; q < NS; ++q) mbar_init(full + q);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  if (producer) {
    if (pt < 4) reinterpret_cast<uint32_t*>(zeros)[pt] = 0u;
    if constexpr (PL) {
      // planes the stack lacks read as +0.0; the loads never write them
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
  const int ar = lane & 15;
  const int ak = (lane >> 4) * 8;
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    if (producer) {
      // the copies of stage s + NS - 1 and the limbs of stage s + 1 while
      // the compute warps run stage s
      if (s + NS - 1 < stages) load(s + NS - 1);
      cp_async_commit();
      if (s + 1 < stages) limb(s + 1);
    } else {
      const int nch = (stage_k(s) + KC - 1) / KC;
      const int buf = s & 1;
      const int q = s % NS;
      if constexpr (TMAB) mbar_wait(full + q, (s / NS) & 1);
#pragma unroll 1
      for (int c = 0; c < nch; ++c) {
        const int kb = c * KC;
        auto a_at = [&](int i, int, int ks) -> const __nv_bfloat16* {
          return ar < M ? As + as_at(buf, i) + ar * ap + kb + ks * 16 + ak
                        : zeros;
        };
        auto b_at = [&](int t, int j, int, int ks) -> const __nv_bfloat16* {
          const int kr = kb + ks * 16 + ar;
          return (PL ? Bp + bp_at(q, j) : Bl + bl_at(buf, t, j)) +
                 kr * DEC_N + dec_col(kr, 8 * w);
        };
        chunk_step<NL, NO, NOUT, 1, 1, LN>(acc, nl, mo, rn, ro, a_at, b_at);
        if constexpr (SPLIT) {
          // this chunk's sums (acc started the chunk at +0.0), then +0.0
          // again for the next chunk
          const int lc = s * (dk / KC) + c;
#pragma unroll
          for (int t = 0; t < NOUT; ++t)
#pragma unroll
            for (int o = 0; o < NO; ++o)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (o <= mo)
                  tots[((lc * NOUT + t) * NO + o) * DEC_M * DEC_N +
                       (g + 8 * (e >> 1)) * DEC_N + 8 * w + 2 * (lane & 3) +
                       (e & 1)] = acc[t][o][0][0][e];
                acc[t][o][0][0][e] = 0.f;
              }
        }
      }
    }
    __syncthreads();
  }
  if constexpr (SPLIT) return;  // the kernel joins the chunks' sums
  if (producer) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1);
    const int64_t gn = n0 + 8 * w + 2 * (lane & 3) + (e & 1);
    if (r >= M || gn >= N) continue;
    if constexpr (PARTS) {
      static_assert(NOUT == 1 && !LN, "partials: one weight, no lanes");
      float per_order[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) per_order[o] = acc[0][o][0][0][e];
      store(r, gn, per_order);
    } else {
      // a lane row joins its own orders, from its own highest one down
      float y[NOUT];
#pragma unroll
      for (int t = 0; t < NOUT; ++t) {
        float per_order[NO];
#pragma unroll
        for (int o = 0; o < NO; ++o) per_order[o] = acc[t][o][0][0][e];
        y[t] = combine_orders<NO>(per_order, LN ? ro[0][e >> 1] : mo);
      }
      store(r, gn, y);
    }
  }
}

// the card's SM count, shared memory an SM and opt-in shared memory a
// block, read once
struct Card {
  int sms = 0, sm_smem = 0, optin = 0;
};

inline cudaError_t card(Card& c) {
  static Card cached;
  if (cached.optin == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached.sms,
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &cached.sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &cached.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) {
      cached.optin = 0;
      return err;
    }
  }
  c = cached;
  return cudaSuccess;
}

// The single-block decode tile's k per stage for blocks blocks of nout
// weights: the ring's most (ring_k; K rounded up to a multiple of KC when
// shorter), halved, in multiples of KC and down to KC, until the rings and
// planes fit the card's opt-in shared memory and, where there are more
// blocks than SMs, until two blocks fit on one SM
__host__ __device__ inline int dec_stage_k(bool pl, int nl, int M, int64_t K,
                                           int nout, int64_t blocks,
                                           int ring_k, int sms,
                                           int64_t sm_smem, int64_t optin) {
  auto smem_of = [&](int dk) {
    const int64_t stages = dk > 0 ? (K + dk - 1) / dk : 0;
    const int slots = (int)(stages < DecRing<1>::S ? stages : DecRing<1>::S);
    return dec_smem_bytes(pl, nl, M, dk, slots, nout);
  };
  auto half = [](int dk) { return (dk / 2 + KC - 1) / KC * KC; };
  int dk = (int)(K < ring_k ? (K + KC - 1) / KC * KC : ring_k);
  while (dk > KC && smem_of(dk) > optin) dk = half(dk);
  if (blocks > sms)
    // 1 KB of each block's shared memory is the runtime's
    while (dk > KC && 2 * (smem_of(dk) + 1024) > sm_smem) dk = half(dk);
  return dk;
}

// Launch one decode-tile kernel: blocks of DEC_CT compute threads and the
// producer warps over the N columns (x), ny groups of NOUT weights (y) and
// the batch (z), at dec_stage_k's k per stage (or the tuner's dk_req).  It
// only stages the loads: the chunks and every add keep their order, so the
// bits do not depend on it.  The kernel's dynamic shared memory limit is
// raised to the card's once per kernel.
template <int NL, int NOUT, auto kernel, typename Args>
cudaError_t launch_decode(const Args& p, bool pl, int nl, int64_t M,
                          int64_t N, int64_t K, unsigned ny, int64_t nz,
                          int dk_req, cudaStream_t st) {
  Card cd;
  cudaError_t err = card(cd);
  if (err != cudaSuccess) return err;
  const int optin = cd.optin;
  static bool raised = false;
  if (!raised) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  auto smem_of = [&](int dk) {
    const int64_t stages = dk > 0 ? (K + dk - 1) / dk : 0;
    const int slots =
        (int)(stages < DecRing<NL>::S ? stages : DecRing<NL>::S);
    return dec_smem_bytes(pl, nl, (int)M, dk, slots, NOUT);
  };
  const dim3 grid((unsigned)((N + DEC_N - 1) / DEC_N), ny, (unsigned)nz);
  int dk = dec_stage_k(pl, nl, (int)M, K, NOUT,
                       (int64_t)grid.x * grid.y * grid.z, DecRing<NL>::K,
                       cd.sms, cd.sm_smem, optin);
  if (dk_req > 0) {
    // the tuner's stage: a multiple of KC within the ring and the card
    if (dk_req % KC || dk_req > DecRing<NL>::K || smem_of(dk_req) > optin)
      return cudaErrorInvalidValue;
    dk = dk_req;
  }
  const int64_t smem = smem_of(dk);
  const unsigned threads = (unsigned)(DEC_CT + 32 * DecRing<NL>::P(pl));
  kernel<<<grid, threads, (size_t)smem, st>>>(p, dk);
  return cudaGetLastError();
}

// the formats with their own instantiations (the rest run the generic one)
inline bool builtin_format(int64_t n_limbs, int64_t max_order) {
  return (n_limbs == 1 || n_limbs == 2 || n_limbs == 3 || n_limbs == 5 ||
          n_limbs == 7) &&
         max_order == n_limbs - 1;
}

inline bool format_ok(int64_t n_limbs, int64_t max_order) {
  return n_limbs >= 1 && n_limbs <= GEN_NL && max_order >= 0 &&
         max_order <= 2 * (n_limbs - 1);
}

}  // namespace
