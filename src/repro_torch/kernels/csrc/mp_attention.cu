// Multi-precision flash attention and paged decode attention for Hopper
// (sm_90a), plain C interface.  paged_kernel and mixed_paged_kernel (below
// flash_kernel) replace _paged_kernel and _mixed_paged_kernel; their own
// comments say how.
//
// flash_kernel replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/mp_attention.py (entered there through
// mp_attention_pallas).  Each query row walks the kv tiles of BKV = 32
// positions in order and folds each into its running (m, d, acc).
//
// The order of every sum is part of the function (below: why), and this is
// it, for each query row and kv tile:
//   1. q is scaled by `scale` in f32, then limbed at fmt_qk (the bf16 RNE
//      cascade); K and V are limbed at fmt_qk and fmt_pv;
//   2. each kept limb pair (i, j) of a logit is one f32 fmaf chain over the
//      head dims 0..D-1 in order, from +0.0 (D: Dh rounded up to 16, 32,
//      64, 128 or 192, the dims past Dh zero);
//   3. the pairs are joined by combine(): plain adds in `products` order
//      (highest order first, i ascending within an order) at <= 3 limbs,
//      per-order sums joined by a Neumaier sum above; the logit is -1e30
//      where the position is invalid (t >= T, or causal and t > the query's
//      position q_offset + s);
//   4. m_new = max(m, the tile's max logit) (exact, so in any order);
//   5. p = expf(logit - m_new), re-zeroed where the position is invalid,
//      then limbed at fmt_pv (at M8 a rounding to bf16);
//   6. sum = sum + p over the tile's columns in order, from +0.0;
//   7. alpha = expf(m - m_new); d = d * alpha + sum and acc = acc * alpha +
//      pv, each rounded twice (--fmad=false);
//   8. each kept P V limb pair is one fmaf chain over the tile's 32 columns
//      in order, from +0.0, joined by combine() as in 3.
//   out = acc / max(d, 1e-30).  The causal walk of a row ends with the kv
//   tile that holds the last position of the row's order tile (the OQ = 32
//   rows it belongs to); a tile past the row's own diagonal is an exact
//   no-op for it.  q_offset shifts the query positions.
//
// Why the order: P is limbed against the running max, and at M8 (the
// serving default's attn_pv) limbing is a rounding to bf16.  A logit one
// f32 unit off, from another order of the same sum, can put p across a
// bf16 boundary and move the output by ~6e-5, over the 2e-5 gate against
// the plain version (which sums QK in this order).  So QK does not use the
// tensor cores: mma.sync adds a k16 step in its own order, which no plain
// PyTorch version reproduces; the FMAs stay f32 chains on the CUDA cores.
//
// The design.  A block of BQ query rows (16, 32 or 64: the largest whose
// grid B * H * ceil(S / BQ) reaches the card's SM count, within shared
// memory; the rows change no bit) has NT = 128 threads: a warp per 16
// rows, and the other warps (3 at BQ = 16) only copy and limb.  Causal
// blocks start with the last q tile, the one with the most kv tiles.  Per
// kv tile, between two barriers, the block limbs the tile's K and V once,
// from an f32 staging buffer that cp.async filled while the previous tile
// ran; the next tile's copies start right after.  Then each warp runs its
// 16 rows alone (no barrier):
//   - QK: a lane holds a 4 x 4 micro-tile of logits (rows 4 * (lane / 8)..,
//     columns 4 * (lane % 8)..), one register chain per kept product, with
//     operands from dim-major limb planes in 16-byte loads issued a step
//     ahead (4 loads feed 48 FMAs at M16);
//   - the softmax on every lane: the row max by shuffles over the 8 lanes
//     of a row, expf and the P limbs of its 16 values; each row's 32 p are
//     added in column order by one lane (two lanes repeat each sum, so the
//     warp does not diverge);
//   - P V: the lane's 4 rows x 4 dims of each 32-dim chunk, the same way.
// The serving formats (M8, M16, M23 on either side) at D = 64 are
// instantiations with their products fixed at compile time, chained in one
// pass over f32 limb planes; every other format and head dim runs the
// generic instantiation (runtime formats, one pass per product, bf16
// planes: half the shared memory), with the same chains and so the same
// bits.
//
// What bounds it on this card: the f32 FMAs of the limb products.  At the
// serving prefill shape (8 x 256 x 12 heads x 64, M16/M8) they are 906 M,
// 0.027 ms at the card's 67 TFLOP/s f32 rate (its SM clock held 1980 MHz
// through the kernel), beside 0.0075 ms for the bytes (q, k, v and out at
// 3.35 TB/s).  Beside the FMAs the SMs issue the chains' loads, the
// softmax, the limbing and the copies, and they wait at the two barriers
// of each kv tile, with 8 warps an SM (shared memory holds two 64-row
// blocks).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false (no
// --use_fast_math): expf is the accurate one, and d * alpha + sum(p) and
// acc * alpha + pv round twice, as in the PyTorch plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BKV = 32;            // kv positions per tile
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;   // per-block shared memory on sm_90
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// limb cascade of x into n planes: plane l at dst[l * plane]
__device__ __forceinline__ void store_limbs(float x, __nv_bfloat16* dst,
                                            int plane, int n) {
  float r = x;
  for (int l = 0; l < n; ++l) {
    const __nv_bfloat16 li = __float2bfloat16_rn(r);
    dst[l * plane] = li;
    r = r - bf(li);
  }
}

// Neumaier's correction term of s + x = t (elementwise for float2)
__device__ __forceinline__ float neumaier(float s, float x, float t) {
  return (fabsf(s) >= fabsf(x)) ? ((s - t) + x) : ((x - t) + s);
}

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 neumaier(float2 s, float2 x, float2 t) {
  return make_float2(neumaier(s.x, x.x, t.x), neumaier(s.y, x.y, t.y));
}

// The limb products of one contraction element (T = float; float2 or F16:
// several elements with the same formats) joined under _matmul_limbs'
// discipline: dot(i, j) is the full dot product of limb i of the left
// operand with limb j of the right one.
template <class T = float, class Dot>
__device__ __forceinline__ T combine(int nl, int mo, Dot dot) {
  T out{}, s{}, c{};
  bool first = true;
  int n_orders = 0;
  for (int o = mo; o >= 0; --o) {
    T osum{};
    bool ofirst = true;
    const int ilo = o - (nl - 1) > 0 ? o - (nl - 1) : 0;
    const int ihi = o < nl - 1 ? o : nl - 1;
    for (int i = ilo; i <= ihi; ++i) {
      const T pr = dot(i, o - i);
      if (nl <= 3) {
        out = first ? pr : out + pr;
        first = false;
      } else {
        osum = ofirst ? pr : osum + pr;
        ofirst = false;
      }
    }
    if (nl > 3) {
      if (n_orders == 0) {
        s = osum;
      } else {
        const T tmp = s + osum;
        c = c + neumaier(s, osum, tmp);
        s = tmp;
      }
      ++n_orders;
    }
  }
  if (nl <= 3) return out;
  return n_orders == 1 ? s : s + c;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous global -> shared copies of which the first `bytes` come
// from src, the rest zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---------------------------------------------------------------------------
// flash_kernel
// ---------------------------------------------------------------------------
constexpr int OQ = 32;             // the order's q tile: causal walks end
                                   // together for its rows
constexpr int WR = 16;             // query rows per warp
constexpr int MAX_BQ = 64;         // query rows per block (16, 32 or 64)
constexpr int NT = 128;            // threads per block: a warp per 16 rows,
                                   // the others copy and limb only
constexpr int PTS = WR + 4;        // padded column of a warp's P limb plane
constexpr int PFS = BKV + 4;       // padded row of a warp's f32 p tile

struct FlashArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t q_sb, q_ss, q_sh;        // element strides; the head dim is unit
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int H, S, T, Dh;
  int causal, q_offset;
  float scale;
  int nl_qk, mo_qk, nl_pv, mo_pv;
  int bq;                          // query rows per block
  int vec;                         // K, V rows 16-byte aligned: 16-byte copies
};

// the 16 values of a lane's 4 x 4 micro-tile, row-major
struct F16 {
  float v[16];
};

__device__ __forceinline__ F16 operator+(const F16& a, const F16& b) {
  F16 r;
#pragma unroll
  for (int x = 0; x < 16; ++x) r.v[x] = a.v[x] + b.v[x];
  return r;
}

__device__ __forceinline__ F16 neumaier(const F16& s, const F16& x,
                                        const F16& t) {
  F16 r;
#pragma unroll
  for (int y = 0; y < 16; ++y) r.v[y] = neumaier(s.v[y], x.v[y], t.v[y]);
  return r;
}

// 4 consecutive limb values of a plane (16-byte aligned f32, 8-byte aligned
// bf16; bf16 -> f32 is exact)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// stores of limb values (bf16-exact, so the bf16 planes lose nothing)
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }

__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// the next limb of a cascade (store_limbs' steps): bf16(r), and r less it
__device__ __forceinline__ float next_limb(float& r) {
  const float li = bf(__float2bfloat16_rn(r));
  r = r - li;
  return li;
}

__device__ __forceinline__ float4 next_limb4(float4& r) {
  return make_float4(next_limb(r.x), next_limb(r.y), next_limb(r.z),
                     next_limb(r.w));
}

// the number of kept limb products of a format; products order is highest
// order first, i ascending within an order (combine's order)
__host__ __device__ constexpr int n_products(int nl, int mo) {
  int n = 0;
  for (int o = mo; o >= 0; --o)
    n += (o < nl - 1 ? o : nl - 1) - (o - (nl - 1) > 0 ? o - (nl - 1) : 0) + 1;
  return n;
}

// the k-th kept limb product (i, j) of a format in products order
__device__ __forceinline__ void product_at(int k, int nl, int mo, int& i,
                                           int& j) {
  for (int o = mo; o >= 0; --o) {
    const int ilo = max(0, o - (nl - 1));
    const int n = min(o, nl - 1) - ilo + 1;
    if (k < n) {
      i = ilo + k;
      j = o - i;
      return;
    }
    k -= n;
  }
  i = j = 0;
}

// acc[4 r + c] = fmaf(x[r], y[c], acc[4 r + c])
__device__ __forceinline__ void fma44(float (&acc)[16], float4 x, float4 y) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
  const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[4 * r + c] = fmaf(xs[r], ys[c], acc[4 * r + c]);
}

// A lane's 4 x 4 micro-tile of one limb contraction: element (r, c) is
// combine() over the kept limb products (i, j) of the chain over e < L, in
// order from +0.0, of a_i[e][r] * b_j[e][c].  Limb plane l of A starts at
// a + l * AP, its row e at e * AS, the lane's 4 values at 0..3; B likewise.
// NL > 0: the format (NL limbs, order cut MO <= 2, so plain adds in products
// order) fixed at compile time, every product chained in one pass over e;
// NL == 0: the format (nl, mo) at run time, one pass per product.  The same
// chains and the same joins either way.
template <int L, int AS, int AP, int BS, int BP, int NL, int MO, class T>
__device__ __forceinline__ F16 tile_chains(const T* a, const T* b, int nl,
                                           int mo) {
  if constexpr (NL > 0) {
    static_assert(NL <= 3, "compile-time formats join by plain adds");
    constexpr int NP = n_products(NL, MO);
    float acc[NP][16];
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
      for (int x = 0; x < 16; ++x) acc[k][x] = 0.f;
    // the operands of step e + 1 are loaded while step e runs
    float4 x[NL], y[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      x[l] = ld4(a + l * AP);
      y[l] = ld4(b + l * BP);
    }
#pragma unroll 4
    for (int e = 0; e < L; ++e) {
      const int en = e + 1 < L ? e + 1 : e;
      float4 xn[NL], yn[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        xn[l] = ld4(a + l * AP + en * AS);
        yn[l] = ld4(b + l * BP + en * BS);
      }
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        int i, j;                        // constants once unrolled
        product_at(k, NL, MO, i, j);
        fma44(acc[k], x[i], y[j]);
      }
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        x[l] = xn[l];
        y[l] = yn[l];
      }
    }
    F16 out;
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      float s = acc[0][x];
#pragma unroll
      for (int k = 1; k < NP; ++k) s = s + acc[k][x];
      out.v[x] = s;
    }
    return out;
  } else {
    return combine<F16>(nl, mo, [&](int i, int j) {
      F16 s;
#pragma unroll
      for (int x = 0; x < 16; ++x) s.v[x] = 0.f;
#pragma unroll 4
      for (int e = 0; e < L; ++e)
        fma44(s.v, ld4(a + i * AP + e * AS), ld4(b + j * BP + e * BS));
      return s;
    });
  }
}

// byte offsets of a flash block's shared memory: the f32 staging buffer
// (K rows, then V rows, each padded by 4 floats), the K limb planes
// (dim-major: [limb][dim][column]), the V limb planes ([limb][position]
// [dim], DV = max(D, 32) dims), then per warp its Q limb planes
// ([limb][dim][16 rows]) and one region that holds its f32 p tile ([16
// rows][PFS]) and then its P limb planes ([limb][column][PTS])
struct FlashSmem {
  int64_t kt, vs, warps, pt, per_warp, total;
};

__host__ __device__ inline FlashSmem flash_smem(int D, int bq, int nlq,
                                                int nlp, int sq, int sp) {
  const int64_t dv = D < 32 ? 32 : D;
  const int64_t p_limbs = (int64_t)nlp * BKV * PTS * sp;
  const int64_t p_f32 = (int64_t)WR * PFS * 4;
  FlashSmem s;
  int64_t o = 2 * BKV * (D + 4) * 4;
  s.kt = o;       o += (int64_t)nlq * D * BKV * sq;
  s.vs = o;       o += (int64_t)nlp * BKV * dv * sp;
  s.warps = o;
  s.pt = (int64_t)nlq * D * WR * sq;
  s.per_warp = s.pt + (p_limbs > p_f32 ? p_limbs : p_f32);
  s.total = o + (int64_t)(bq / WR) * s.per_warp;
  return s;
}

template <int D, int NLQ, int MOQ, int NLP, int MOP>
__global__ void __launch_bounds__(NT) flash_kernel(FlashArgs p) {
  // the serving formats' planes hold f32 limbs (no conversion in the
  // chains); the generic instantiation's bf16 ones (half the bytes)
  using TQ = std::conditional_t<(NLQ > 0), float, __nv_bfloat16>;
  using TP = std::conditional_t<(NLP > 0), float, __nv_bfloat16>;
  constexpr int DV = D < 32 ? 32 : D;    // V plane width: 32-dim chunks
  constexpr int NJ = DV / 32;            // P V chunks a lane takes
  constexpr int DS = D + 4;              // padded row of the staging buffer
  constexpr int D4 = D / 4;
  const int nlq = NLQ > 0 ? NLQ : p.nl_qk;
  const int moq = NLQ > 0 ? MOQ : p.mo_qk;
  const int nlp = NLP > 0 ? NLP : p.nl_pv;
  const int mop = NLP > 0 ? MOP : p.mo_pv;
  const int bq = p.bq;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const FlashSmem L = flash_smem(D, bq, nlq, nlp, sizeof(TQ), sizeof(TP));
  float* st = reinterpret_cast<float*>(base);   // [K|V][BKV][DS]
  TQ* kt = reinterpret_cast<TQ*>(base + L.kt);
  TP* vs = reinterpret_cast<TP*>(base + L.vs);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int rg = lane >> 3;              // the lane's rows 4 rg .. 4 rg + 3
  const int cg = lane & 7;               // its columns / dims 4 cg ..
  char* wbase = base + L.warps + (w < bq / WR ? w : 0) * L.per_warp;
  TQ* qw = reinterpret_cast<TQ*>(wbase);
  TP* pt = reinterpret_cast<TP*>(wbase + L.pt);
  float* pf = reinterpret_cast<float*>(wbase + L.pt);   // p, then P's limbs

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;   // the last q tile first
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  float* o = p.o + b * p.o_sb + h * p.o_sh;

  // the kv tiles this block walks: a causal walk ends with the tile holding
  // the last position of the order tile of the block's last row; a warp
  // takes the tiles of its own order tile
  int ntile = (p.T + BKV - 1) / BKV;
  const int wq0 = q0 + w * WR;           // the warp's first row
  int wtile = ntile;
  if (p.causal) {
    const int last = p.q_offset + (q0 + bq - 1) / OQ * OQ + OQ - 1;
    ntile = min(ntile, last / BKV + 1);
    wtile = min(ntile, (p.q_offset + wq0 / OQ * OQ + OQ - 1) / BKV + 1);
  }
  if (w >= bq / WR || wq0 >= p.S) wtile = 0;  // no rows to compute

  // copies of kv tile t's K and V rows into the staging buffer (rows past T
  // and dims past Dh zero-filled)
  auto issue = [&](int t) {
    const int t0 = t * BKV;
#pragma unroll 4
    for (int idx = tid; idx < 2 * BKV * D4; idx += NT) {
      const int row = idx / D4;
      const int d4 = (idx - row * D4) * 4;
      const int kv = row >= BKV;
      const int tp = t0 + row - kv * BKV;
      const float* src =
          kv ? v + (int64_t)tp * p.v_ss : k + (int64_t)tp * p.k_ss;
      const float* zero = kv ? v : k;    // a valid address for 0-byte copies
      float* to = st + row * DS + d4;
      if (p.vec) {
        const int bytes = tp < p.T && d4 < p.Dh ? 16 : 0;
        cp_async16(to, bytes ? src + d4 : zero, bytes);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bytes = tp < p.T && d4 + e < p.Dh ? 4 : 0;
          cp_async4(to + e, bytes ? src + d4 + e : zero, bytes);
        }
      }
    }
    cp_async_commit();
  };

  if (ntile > 0) issue(0);
  // Q: scaled in f32, then limbed (rows past S and dims past Dh are 0)
  for (int idx = tid; idx < bq * D4; idx += NT) {
    const int r = idx % bq;
    const int d4 = (idx / bq) * 4;
    const int s = q0 + r;
    TQ* dst = reinterpret_cast<TQ*>(base + L.warps + (r / WR) * L.per_warp) +
              d4 * WR + r % WR;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float x = s < p.S && d4 + u < p.Dh
                    ? q[(int64_t)s * p.q_ss + d4 + u] * p.scale
                    : 0.f;
      for (int l = 0; l < nlq; ++l)
        st1(dst + l * D * WR + u * WR, next_limb(x));
    }
  }
  if constexpr (DV > D) {                // V planes' dims past D stay zero
    for (int idx = tid; idx < nlp * BKV * (DV - D); idx += NT) {
      const int row = idx / (DV - D);
      st1(vs + row * DV + D + idx % (DV - D), 0.f);
    }
  }

  float m[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
  float d_own = 0.f;                     // d of row 4 rg + cg % 4
  float acc[NJ][16];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int x = 0; x < 16; ++x) acc[j][x] = 0.f;

  for (int t = 0; t < ntile; ++t) {
    const int t0 = t * BKV;
    cp_async_wait_all();
    __syncthreads();  // tile t is staged; every warp is done with tile t - 1
    // limb K into dim-major planes (a lane per column) and V as it is
#pragma unroll 4
    for (int idx = tid; idx < BKV * D4; idx += NT) {
      const int c = idx % BKV;
      const int d4 = (idx / BKV) * 4;
      float4 x = *reinterpret_cast<const float4*>(st + c * DS + d4);
      for (int l = 0; l < nlq; ++l) {
        const float4 li = next_limb4(x);
        TQ* dst = kt + l * D * BKV + d4 * BKV + c;
        st1(dst, li.x);
        st1(dst + BKV, li.y);
        st1(dst + 2 * BKV, li.z);
        st1(dst + 3 * BKV, li.w);
      }
    }
#pragma unroll 4
    for (int idx = tid; idx < BKV * D4; idx += NT) {
      const int c = idx / D4;
      const int d4 = (idx - c * D4) * 4;
      float4 x = *reinterpret_cast<const float4*>(st + (BKV + c) * DS + d4);
      for (int l = 0; l < nlp; ++l)
        st4(vs + l * BKV * DV + c * DV + d4, next_limb4(x));
    }
    __syncthreads();  // the planes are ready and the staging buffer free
    if (t + 1 < ntile) issue(t + 1);
    if (t >= wtile) continue;            // an exact no-op for the warp's rows

    // logits of the lane's 4 rows x 4 columns
    F16 lg = tile_chains<D, WR, D * WR, BKV, D * BKV, NLQ, MOQ>(
        qw + 4 * rg, kt + 4 * cg, nlq, moq);
    // a position is valid below the row's bound: T, and causal its own
    // position + 1; the logit is -1e30 past it
    int lim[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = p.q_offset + wq0 + 4 * rg + r;
      lim[r] = p.causal && qpos + 1 < p.T ? qpos + 1 : p.T;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (t0 + 4 * cg + c >= lim[r]) lg.v[4 * r + c] = NEG_INF;
    }
    // the softmax step of the lane's 16 values: the row max over the 8 lanes
    // that hold a row (exact), p (expf(-inf) = +0: the re-zeroing), alpha
    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(lg.v[4 * r], lg.v[4 * r + 1]),
                       fmaxf(lg.v[4 * r + 2], lg.v[4 * r + 3]));
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float pr[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pr[c] = expf(t0 + 4 * cg + c < lim[r] ? lg.v[4 * r + c] - m_new
                                              : -INFINITY);
      *reinterpret_cast<float4*>(pf + (4 * rg + r) * PFS + 4 * cg) =
          make_float4(pr[0], pr[1], pr[2], pr[3]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    __syncwarp();
    // the row sums in column order: lane (rg, cg) adds row 4 rg + cg % 4
    // (lanes cg and cg + 4 the same row, so the warp does not diverge)
    {
      const float* row = pf + (4 * rg + (cg & 3)) * PFS;
      float sum = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < BKV; c4 += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + c4);
        sum = sum + x.x;
        sum = sum + x.y;
        sum = sum + x.z;
        sum = sum + x.w;
      }
      const int r = cg & 3;
      const float al = r == 0 ? alpha[0]
                     : r == 1 ? alpha[1]
                     : r == 2 ? alpha[2]
                              : alpha[3];
      d_own = d_own * al + sum;
    }
    // P's limbs, over p: a lane per column, 4 rows at a time
    float4 pc[WR / 4];
#pragma unroll
    for (int r4 = 0; r4 < WR / 4; ++r4)
      pc[r4] = make_float4(pf[4 * r4 * PFS + lane],
                           pf[(4 * r4 + 1) * PFS + lane],
                           pf[(4 * r4 + 2) * PFS + lane],
                           pf[(4 * r4 + 3) * PFS + lane]);
    __syncwarp();
    for (int l = 0; l < nlp; ++l)
#pragma unroll
      for (int r4 = 0; r4 < WR / 4; ++r4)
        st4(pt + l * BKV * PTS + lane * PTS + 4 * r4, next_limb4(pc[r4]));
    __syncwarp();
    // acc = acc * alpha + P V: the lane's 4 rows x 4 dims of each chunk
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const F16 pv = tile_chains<BKV, PTS, BKV * PTS, DV, BKV * DV, NLP, MOP>(
          pt + 4 * rg, vs + 4 * cg + 32 * j, nlp, mop);
#pragma unroll
      for (int x = 0; x < 16; ++x)
        acc[j][x] = acc[j][x] * alpha[x / 4] + pv.v[x];
    }
  }

  float dr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    dr[r] = __shfl_sync(FULL, d_own, (lane & ~7) | r);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = wq0 + 4 * rg + r;
    if (w >= bq / WR || s >= p.S) continue;
    const float dn = fmaxf(dr[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int dd = 32 * j + 4 * cg + u;
        if (dd < p.Dh) o[(int64_t)s * p.o_ss + dd] = acc[j][4 * r + u] / dn;
      }
  }
}

// The block's query rows: the largest of 64, 32, 16 whose grid B * H *
// ceil(S / BQ) reaches n_sm blocks (16 where none does) and whose shared
// memory fits; 0 where not even 16 rows fit.  Sets p.bq and returns the
// shared memory in bytes.
int64_t flash_plan(int D, int sq, int sp, int64_t BH, int n_sm, FlashArgs& p) {
  for (int bq = MAX_BQ; bq >= WR; bq /= 2) {
    const int64_t smem = flash_smem(D, bq, p.nl_qk, p.nl_pv, sq, sp).total;
    if (smem > MAX_SMEM) continue;
    if (bq == WR || BH * ((p.S + bq - 1) / bq) >= n_sm) {
      p.bq = bq;
      return smem;
    }
  }
  return 0;
}

bool serving_format(int nl, int mo) {
  return nl >= 1 && nl <= 3 && mo == nl - 1;
}

// Dh rounded up to the head dims the kernels are built for (192, MLA's
// 128 + 64, for flash_kernel only: the paged kernels take Dh <= 128)
int padded_d(int64_t Dh) {
  return Dh <= 16 ? 16 : Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 128 ? 128
                                                                    : 192;
}

// the instantiation a launch takes: the serving formats at D = 64 fixed at
// compile time, the rest generic
bool flash_special(int D, int nl_qk, int mo_qk, int nl_pv, int mo_pv) {
  return D == 64 && serving_format(nl_qk, mo_qk) &&
         serving_format(nl_pv, mo_pv);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return n;
}

// bq_req: the block's rows (16, 32 or 64), or 0 for flash_plan's choice
template <int D, int NLQ, int MOQ, int NLP, int MOP>
cudaError_t flash_launch(FlashArgs p, int B, int bq_req, cudaStream_t st) {
  constexpr int sq = NLQ > 0 ? 4 : 2;
  constexpr int sp = NLP > 0 ? 4 : 2;
  int64_t smem;
  if (bq_req) {
    p.bq = bq_req;
    smem = flash_smem(D, bq_req, p.nl_qk, p.nl_pv, sq, sp).total;
    if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  } else {
    smem = flash_plan(D, sq, sp, (int64_t)B * p.H, sm_count(), p);
    if (smem == 0) return cudaErrorInvalidValue;
  }
  auto* kern = flash_kernel<D, NLQ, MOQ, NLP, MOP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(B * p.H), (unsigned)((p.S + p.bq - 1) / p.bq), 1);
  kern<<<grid, NT, (size_t)smem, st>>>(p);
  return cudaGetLastError();
}

template <int NLQ>
cudaError_t flash_special_pv(const FlashArgs& p, int B, int bq,
                             cudaStream_t st) {
  switch (p.nl_pv) {
    case 1: return flash_launch<64, NLQ, NLQ - 1, 1, 0>(p, B, bq, st);
    case 2: return flash_launch<64, NLQ, NLQ - 1, 2, 1>(p, B, bq, st);
    default: return flash_launch<64, NLQ, NLQ - 1, 3, 2>(p, B, bq, st);
  }
}

cudaError_t flash_dispatch(FlashArgs p, int B, int bq, cudaStream_t st) {
  const int D = padded_d(p.Dh);
  if (flash_special(D, p.nl_qk, p.mo_qk, p.nl_pv, p.mo_pv)) {
    switch (p.nl_qk) {
      case 1: return flash_special_pv<1>(p, B, bq, st);
      case 2: return flash_special_pv<2>(p, B, bq, st);
      default: return flash_special_pv<3>(p, B, bq, st);
    }
  }
  switch (D) {
    case 16: return flash_launch<16, 0, 0, 0, 0>(p, B, bq, st);
    case 32: return flash_launch<32, 0, 0, 0, 0>(p, B, bq, st);
    case 64: return flash_launch<64, 0, 0, 0, 0>(p, B, bq, st);
    case 128: return flash_launch<128, 0, 0, 0, 0>(p, B, bq, st);
    default: return flash_launch<192, 0, 0, 0, 0>(p, B, bq, st);
  }
}

struct PagedArgs {
  const float* q;                  // (B, H, Dh), head dim unit-stride
  const float* k;                  // pools (n_blocks, bs, Hkv, Dh)
  const float* v;
  const int32_t* table;            // (B, W) physical block ids
  const int32_t* lengths;          // (B,) valid prefix per slot
  float* o;                        // (B, H, Dh) contiguous
  int64_t q_sb, q_sh;
  int64_t k_sb, k_ss, k_sh;        // pool strides: block, position, head
  int64_t v_sb, v_ss, v_sh;
  int64_t t_sb;
  int H, n_rep, Dh, bs, W;
  float scale;
  int nl_qk, mo_qk, nl_pv, mo_pv;  // the formats (mixed: the envelopes)
  // mixed_paged_kernel: per-slot lanes (B,) each; null for paged_kernel
  const int32_t* lane_qk_n;
  const int32_t* lane_qk_ord;
  const int32_t* lane_pv_n;
  const int32_t* lane_pv_ord;
  int cols;                        // table columns per chunk (paged_plan)
  int vec;                         // pool rows 16-byte aligned: 16-byte copies
};

// Replaces the Pallas TPU kernels _paged_kernel and _mixed_paged_kernel of
// src/repro/kernels/mp_attention.py (entered there through
// mp_paged_attention_pallas and mp_mixed_paged_attention_pallas).
//
// The function: one decode query per slot against the paged KV pool.  Slot
// b walks its table columns j < min(ceil(length / bs), W) (the columns past
// them hold the trash block and are never read); column j is pool block
// table[b, j], positions j * bs .. j * bs + bs - 1.  Each column is folded
// into the running (m, d, acc) of each query head as the TPU kernel's grid
// column folds it:
//   l = Q K^T at fmt_qk (q scaled in f32 before it is limbed), -1e30 past
//       the length;
//   m_j = max(m_{j-1}, max of l over the column), m_{-1} = -1e30;
//   p = exp(l - m_j), re-zeroed past the length, limbed at fmt_pv;
//   alpha_j = exp(m_{j-1} - m_j); d_j = d_{j-1} * alpha_j + sum(p);
//   acc_j = acc_{j-1} * alpha_j + P V at fmt_pv;
//   out = acc / max(d, 1e-30): a slot of length 0 writes exact zeros.
// Contractions follow _matmul_limbs (combine above), like flash_kernel.
//
// Why m_j must be the walk's own: P is limbed against it, and at M8 (the
// serving default's attn_pv) limbing P is a rounding to bf16, which does
// not commute with the rescaling by alpha (bf16(x * c) != bf16(x) * c).
// The running max each probability sees is part of the function: splitting
// a slot's columns over blocks that each start from -inf and merging their
// partial results (flash-decoding) would round P against other maxima.
// Even the order of a logit's f32 sum matters at M8: a logit one unit off
// can put p across a bf16 rounding boundary, so the kernels keep one order
// (below) and the plain versions sum QK in it.
//
// The design: one block of NTP threads per (kv head, slot) serves the n_rep
// query heads that share the kv head and takes the slot's columns in chunks
// of p.cols columns (paged_plan: CHUNK_POS / bs, 8 at bs 16; fewer only
// where shared memory would not hold them).  Per chunk, phases separated
// by barriers, each on the whole block:
//   1. the chunk's K and V rows, copied by cp.async into an f32 staging
//      buffer while the previous chunk ran (the pool blocks two chunks
//      ahead are read from the table meanwhile), are limbed into bf16
//      planes; then the next chunk's copies start;
//   2. every kept QK limb product of every (head, position) is one f32 FMA
//      chain over the head dims in order, a thread each;
//   3. combine() joins each position's products in products order: the
//      logits;
//   4. a warp per (head, column): m_{j-1} and m_j from the maxima of the
//      chunk's earlier columns, the carried m and the column itself (a max
//      is exact: these are the walk's values whatever the chunk), p and its
//      limbs, sum(p) in position order, alpha_j;
//   5. P V for every (head, column, pair of dims);
//   6. the recurrence over the chunk's columns in order, on the threads
//      that own each dim: acc = acc * alpha_j + pv_j, d = d * alpha_j +
//      sum_j.
// Every sum runs in the order of a walk that folds one column at a time
// with one thread per dot product (each dot product one chain from +0.0,
// the products joined by combine(), sum(p) and the recurrence in order), so
// the output is bitwise that walk's; the chunks only let the phases of 8
// columns run side by side.
//
// Batch invariance: each number above is a function of one column's data
// and the running (m, d, acc) it is folded into, in a fixed order: not of
// the chunk a column falls in, of B, W, other slots, the grid or the SM
// count.  A slot gives the same bits in a launch of 8 slots as alone, and
// the chunk size (which shrinks only where shared memory is short) moves no
// bit.
//
// What bounds it on this card: at the decode shape (8 slots, 12 heads, Dh
// 64, lengths 64..288, M16/M8) the grid is 96 blocks for 132 SMs and the
// block of the longest slot sets the time: 3 chunks of six barrier-separated
// phases, each short, so latency bounds it (0.020 ms on an NVIDIA H100 80GB
// HBM3 at 700 W), not the 8.65 MB of K and V (2.6 us at the card's 3.35
// TB/s).  Removing one part at a time (compare_kernels.py, same card): the
// copies cost the most, then the limbing and the softmax step.  Tensor cores are not used: with n_rep = 1 each block
// has one query row, so QK is a matrix-vector product (an MMA tile of 16
// rows would run 15 empty ones) and P V has one row too.
//
// mixed_paged_kernel: slot b runs at its own QK and PV lane formats, four
// values the block reads from the lane vectors before it starts.  Shared
// memory is laid out for the envelopes (p.nl_qk, p.nl_pv), Q, K, V and P
// are limbed to the slot's own depth, and combine() runs at the slot's
// formats, so a slot's output is bitwise paged_kernel's at the slot's
// formats (lanes are clamped to the envelope, which keeps a bad lane inside
// shared memory).  The TPU kernel runs the envelope's limb loops and masks
// a slot's surplus products to +0.0; this one limbs and contracts at the
// slot's own depth, which leaves the same products out and adds no zeros.
constexpr int NTP = 512;           // threads per paged block
constexpr int CHUNK_POS = 128;     // positions a chunk aims at (8 columns)

// byte offsets of a paged block's shared memory; planes of (envelope) depth
// nlq / nlp, chunks of cols columns of bs positions
struct PagedSmem {
  int64_t raw, pv, s, part, acc, col, md, ids, q, k, v, p, total;
};

__host__ __device__ inline PagedSmem paged_smem(int D, int nr, int bs,
                                                int cols, int nlq, int nlp) {
  const int64_t cp = (int64_t)cols * bs;     // positions per chunk
  const int64_t ds = D + 8;                  // padded row of a limb plane
  PagedSmem s;
  int64_t o = 0;
  s.raw = o;  o += 2 * cp * D * 4;                  // f32 K, V staging
  s.pv = o;   o += (int64_t)nr * cols * D * 4;      // P V per column
  s.s = o;    o += (int64_t)nr * cp * 4;            // logits
  s.part = o; o += (int64_t)nlq * nlq * nr * cp * 4; // QK products, then p
  s.acc = o;  o += (int64_t)nr * D * 4;             // running acc
  s.col = o;  o += (int64_t)3 * nr * cols * 4;      // alpha, sum p, m_j
  s.md = o;   o += (int64_t)2 * nr * 4;             // running m, d
  s.ids = o;  o += (int64_t)2 * cols * 4;           // pool blocks ahead
  o = (o + 15) / 16 * 16;
  s.q = o;    o += (int64_t)nlq * nr * ds * 2;      // bf16 limb planes
  s.k = o;    o += (int64_t)nlq * cp * ds * 2;
  s.v = o;    o += (int64_t)nlp * cp * ds * 2;
  s.p = o;    o += (int64_t)nlp * nr * (cp + 2) * 2;
  s.total = o;
  return s;
}

// limbs of 4 f32 values into n bf16 planes (8-byte aligned, plane stride
// `plane` elements): store_limbs' cascade, two values per conversion
__device__ __forceinline__ void store_limbs4(float4 x, __nv_bfloat16* dst,
                                             int plane, int n) {
  for (int l = 0; l < n; ++l) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    *reinterpret_cast<uint2*>(dst + l * plane) =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                   *reinterpret_cast<uint32_t*>(&hi));
    x.x = x.x - __low2float(lo);
    x.y = x.y - __high2float(lo);
    x.z = x.z - __low2float(hi);
    x.w = x.w - __high2float(hi);
  }
}

// limb_dot of two rows of D bf16 values (16-byte aligned): one f32 FMA
// chain in order from +0.0
template <int D>
__device__ __forceinline__ float dot_row(const __nv_bfloat16* x,
                                         const __nv_bfloat16* y) {
  float acc = 0.f;
#pragma unroll
  for (int h = 0; h < D / 8; ++h) {
    const uint4 xa = reinterpret_cast<const uint4*>(x)[h];
    const uint4 ya = reinterpret_cast<const uint4*>(y)[h];
    const uint32_t xs[4] = {xa.x, xa.y, xa.z, xa.w};
    const uint32_t ys[4] = {ya.x, ya.y, ya.z, ya.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // a bf16 pair's low element first; bf16 -> f32 is exact
      acc = fmaf(__uint_as_float(xs[u] << 16), __uint_as_float(ys[u] << 16),
                 acc);
      acc = fmaf(__uint_as_float(xs[u] & 0xffff0000u),
                 __uint_as_float(ys[u] & 0xffff0000u), acc);
    }
  }
  return acc;
}

// limb_dot of x (unit step) with two neighbouring columns of y (step
// ystep, 4-byte aligned): two chains in order, unrolled so the loads of
// several terms are in flight at once
__device__ __forceinline__ float2 limb_dot2(const __nv_bfloat16* x,
                                            const __nv_bfloat16* y, int ystep,
                                            int len) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
  for (int e = 0; e < len; ++e) {
    const float xe = bf(x[e]);
    const float2 ye = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(y + e * ystep));
    a0 = fmaf(xe, ye.x, a0);
    a1 = fmaf(xe, ye.y, a1);
  }
  return make_float2(a0, a1);
}

template <int D, bool LN>
__device__ __forceinline__ void paged_body(const PagedArgs& p) {
  constexpr int DS = D + 8;              // padded row of a limb plane
  constexpr int NV = D / 4;              // 16-byte pieces of a row
  constexpr int NWARP = NTP / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int nr = p.n_rep;
  const int bs = p.bs;
  const int C = p.cols;
  const int cp = C * bs;                 // positions per chunk
  const int ps = cp + 2;                 // padded row of a P limb plane
  int nl_qk = p.nl_qk, mo_qk = p.mo_qk, nl_pv = p.nl_pv, mo_pv = p.mo_pv;
  if constexpr (LN) {
    nl_qk = max(1, min(p.lane_qk_n[b], p.nl_qk));
    mo_qk = max(0, min(p.lane_qk_ord[b], min(p.mo_qk, 2 * (nl_qk - 1))));
    nl_pv = max(1, min(p.lane_pv_n[b], p.nl_pv));
    mo_pv = max(0, min(p.lane_pv_ord[b], min(p.mo_pv, 2 * (nl_pv - 1))));
  }
  const int nprod = n_products(nl_qk, mo_qk);  // kept QK limb products
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const PagedSmem L = paged_smem(D, nr, bs, C, p.nl_qk, p.nl_pv);
  float* raw = reinterpret_cast<float*>(base + L.raw);   // [K|V][cp][D]
  float* pv_s = reinterpret_cast<float*>(base + L.pv);   // [nr][C][D]
  float* S = reinterpret_cast<float*>(base + L.s);       // [nr][cp]
  float* part_s = reinterpret_cast<float*>(base + L.part);  // [k][nr][cp]
  float* acc_s = reinterpret_cast<float*>(base + L.acc); // [nr][D]
  float* al_s = reinterpret_cast<float*>(base + L.col);  // [nr][C] each
  float* sum_s = al_s + nr * C;
  float* mj_s = sum_s + nr * C;
  float* m_s = reinterpret_cast<float*>(base + L.md);    // [nr] each
  float* d_s = m_s + nr;
  int32_t* ids = reinterpret_cast<int32_t*>(base + L.ids);  // [2][C]
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(base + L.q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(base + L.k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(base + L.v);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(base + L.p);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = p.lengths[b];
  int ncol = (length + bs - 1) / bs;
  if (ncol > p.W) ncol = p.W;
  const int nchunk = (ncol + C - 1) / C;
  const int32_t* trow = p.table + b * p.t_sb;
  const float* kh = p.k + kvh * p.k_sh;
  const float* vh = p.v + kvh * p.v_sh;

  // copies of chunk ch's K and V rows into the staging buffer (dims past Dh
  // zero-filled) from its pool blocks blk[c]; never a column at or past ncol
  auto issue = [&](int ch, const int32_t* blk) {
    const int npos = min(C, ncol - ch * C) * bs;
    for (int idx = tid; idx < 2 * npos * NV; idx += NTP) {
      const int row = idx / NV;
      const int d4 = (idx - row * NV) * 4;
      const int kv = row >= npos;
      const int t = row - kv * npos;
      const int c = t / bs;
      const int i = t - c * bs;
      const int64_t bl = blk[c];
      const float* src = kv ? vh + bl * p.v_sb + i * p.v_ss
                            : kh + bl * p.k_sb + i * p.k_ss;
      float* to = raw + row * D + d4;
      if (p.vec) {
        const int bytes = d4 < p.Dh ? 16 : 0;
        cp_async16(to, bytes ? src + d4 : src, bytes);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bytes = d4 + e < p.Dh ? 4 : 0;
          cp_async4(to + e, bytes ? src + d4 + e : src, bytes);
        }
      }
    }
    cp_async_commit();
  };

  if (nchunk > 0) issue(0, trow);
  // the pool blocks of chunk 1; chunk ch + 2's are read during chunk ch
  if (tid < C && C + tid < ncol) ids[C + tid] = trow[C + tid];
  const float* q = p.q + b * p.q_sb + (int64_t)kvh * nr * p.q_sh;
  for (int idx = tid; idx < nr * D; idx += NTP) {
    const int r = idx / D;
    const int dd = idx % D;
    const float x = dd < p.Dh ? q[r * p.q_sh + dd] * p.scale : 0.f;
    store_limbs(x, Qs + r * DS + dd, nr * DS, nl_qk);
    acc_s[idx] = 0.f;
  }
  if (tid < nr) {
    m_s[tid] = NEG_INF;
    d_s[tid] = 0.f;
  }

  for (int ch = 0; ch < nchunk; ++ch) {
    const int c0 = ch * C;
    const int ncv = min(C, ncol - c0);     // the chunk's columns
    const int npos = ncv * bs;
    const int pos0 = c0 * bs;              // the chunk's first position
    cp_async_wait_all();
    __syncthreads();  // chunk ch is staged; the previous chunk is folded
    if (tid < C && (ch + 2) * C + tid < ncol)
      ids[(ch % 2) * C + tid] = trow[(ch + 2) * C + tid];

    // 1. limb the staged rows
    const float* rv = raw + npos * D;
#pragma unroll 4
    for (int idx = tid; idx < npos * NV; idx += NTP) {
      const int t = idx / NV;
      const int d4 = (idx - t * NV) * 4;
      store_limbs4(*reinterpret_cast<const float4*>(raw + t * D + d4),
                   Ks + t * DS + d4, cp * DS, nl_qk);
      store_limbs4(*reinterpret_cast<const float4*>(rv + t * D + d4),
                   Vs + t * DS + d4, cp * DS, nl_pv);
    }
    __syncthreads();
    // the staging buffer is free: the next chunk's copies run under the
    // rest of this one
    if (ch + 1 < nchunk) issue(ch + 1, ids + ((ch + 1) % 2) * C);

    // 2. every kept QK limb product of every (head, position): one f32 FMA
    // chain over the head dims in order, a thread each (a warp takes 32
    // positions of one product)
    const int nrp = nr * npos;
    for (int idx = tid; idx < nprod * nrp; idx += NTP) {
      const int k = idx / nrp;
      const int rt = idx - k * nrp;
      const int r = rt / npos;
      const int t = rt - r * npos;
      int li, lj;
      product_at(k, nl_qk, mo_qk, li, lj);
      part_s[k * nr * cp + rt] = dot_row<D>(Qs + li * nr * DS + r * DS,
                                            Ks + lj * cp * DS + t * DS);
    }
    __syncthreads();

    // 3. the logits: combine() joins each (head, position)'s products in
    // products order
    for (int rt = tid; rt < nrp; rt += NTP) {
      int k = 0;
      const float lg = combine(nl_qk, mo_qk, [&](int, int) {
        return part_s[(k++) * nr * cp + rt];
      });
      const int r = rt / npos;
      const int t = rt - r * npos;
      S[r * cp + t] = pos0 + t < length ? lg : NEG_INF;
    }
    __syncthreads();

    // 4. the softmax step of each (head, column), a warp each: m_{j-1} and
    // m_j from the maxima of the chunk's earlier columns and of this one
    // (exact), p and its limbs, sum(p) in position order, alpha_j
    for (int rc = warp; rc < nr * ncv; rc += NWARP) {
      const int r = rc / ncv;
      const int c = rc - r * ncv;
      const float* Sr = S + r * cp;
      float mb = NEG_INF, mc = NEG_INF;    // earlier columns, this column
      for (int t = lane; t < c * bs; t += 32) mb = fmaxf(mb, Sr[t]);
      for (int i = lane; i < bs; i += 32) mc = fmaxf(mc, Sr[c * bs + i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, off));
        mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, off));
      }
      const float m_old = fmaxf(m_s[r], mb);   // m_{j-1}
      const float m_new = fmaxf(m_old, mc);    // m_j
      float* pw = part_s + r * cp + c * bs;    // p in f32 (products done)
      for (int i = lane; i < bs; i += 32) {
        const int t = c * bs + i;
        const float pr = pos0 + t < length ? expf(Sr[t] - m_new) : 0.f;
        pw[i] = pr;
        store_limbs(pr, Ps + r * ps + t, nr * ps, nl_pv);
      }
      __syncwarp();
      if (lane == 0) {
        float sum = 0.f;
#pragma unroll 8
        for (int i = 0; i < bs; ++i) sum = sum + pw[i];
        al_s[r * C + c] = expf(m_old - m_new);
        sum_s[r * C + c] = sum;
        mj_s[r * C + c] = m_new;
      }
    }
    __syncthreads();

    // 5. P V of each (head, column) for two neighbouring dims a thread
    for (int idx = tid; idx < nr * ncv * (D / 2); idx += NTP) {
      const int d2 = (idx % (D / 2)) * 2;
      const int rc = idx / (D / 2);
      const int r = rc / ncv;
      const int c = rc - r * ncv;
      const __nv_bfloat16* pp = Ps + r * ps + c * bs;
      const __nv_bfloat16* vp = Vs + c * bs * DS + d2;
      *reinterpret_cast<float2*>(pv_s + (r * C + c) * D + d2) =
          combine<float2>(nl_pv, mo_pv, [&](int i, int j) {
            return limb_dot2(pp + i * nr * ps, vp + j * cp * DS, DS, bs);
          });
    }
    __syncthreads();

    // 6. fold the chunk's columns in order
    for (int idx = tid; idx < nr * D; idx += NTP) {
      const int r = idx / D;
      const int dd = idx % D;
      float a = acc_s[idx];
      for (int c = 0; c < ncv; ++c)
        a = a * al_s[r * C + c] + pv_s[(r * C + c) * D + dd];
      acc_s[idx] = a;
      if (dd == 0) {
        float dv = d_s[r];
        for (int c = 0; c < ncv; ++c)
          dv = dv * al_s[r * C + c] + sum_s[r * C + c];
        d_s[r] = dv;
        m_s[r] = mj_s[r * C + ncv - 1];
      }
    }
  }
  __syncthreads();
  float* o = p.o + ((int64_t)b * p.H + (int64_t)kvh * nr) * p.Dh;
  for (int idx = tid; idx < nr * D; idx += NTP) {
    const int r = idx / D;
    const int dd = idx % D;
    if (dd < p.Dh) o[r * p.Dh + dd] = acc_s[idx] / fmaxf(d_s[r], 1e-30f);
  }
}

// (NTP, 1): one block per SM is all the decode grid asks for; with NTP
// alone ptxas held both entries to 64 registers and spilled
template <int D>
__global__ void __launch_bounds__(NTP, 1) paged_kernel(PagedArgs p) {
  paged_body<D, false>(p);
}

// paged_kernel for a decode micro-batch whose slots run different formats,
// in one launch: slot b's QK and PV formats are (lane_qk_n[b],
// lane_qk_ord[b]) and (lane_pv_n[b], lane_pv_ord[b]) at or below the
// envelopes.  One body with paged_kernel (see there).
template <int D>
__global__ void __launch_bounds__(NTP, 1) mixed_paged_kernel(PagedArgs p) {
  paged_body<D, true>(p);
}

// The chunk: CHUNK_POS positions' worth of columns (at least one), halved
// while shared memory cannot hold it.  A function of D, bs, n_rep and the
// (envelope) depths only.  Sets p.cols and returns the shared memory in
// bytes, or 0 where not even one column fits.
int64_t paged_plan(int D, PagedArgs& p) {
  for (int cols = CHUNK_POS / p.bs > 1 ? CHUNK_POS / p.bs : 1; cols >= 1;
       cols /= 2) {
    const int64_t smem =
        paged_smem(D, p.n_rep, p.bs, cols, p.nl_qk, p.nl_pv).total;
    if (smem <= MAX_SMEM) {
      p.cols = cols;
      return smem;
    }
  }
  return 0;
}

template <int D, bool LN>
cudaError_t launch_paged(PagedArgs p, int B, int Hkv, cudaStream_t st) {
  const int64_t smem = paged_plan(D, p);
  if (smem == 0) return cudaErrorInvalidValue;
  auto* kern = LN ? mixed_paged_kernel<D> : paged_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)Hkv, (unsigned)B, 1);
  kern<<<grid, NTP, (size_t)smem, st>>>(p);
  return cudaGetLastError();
}

bool paged_args_ok(int64_t B, int64_t H, int64_t Hkv, int64_t Dh, int64_t bs,
                   int64_t W, int64_t nl_qk, int64_t mo_qk, int64_t nl_pv,
                   int64_t mo_pv) {
  return nl_qk >= 1 && nl_pv >= 1 && mo_qk >= 0 && mo_pv >= 0 &&
         mo_qk <= 2 * (nl_qk - 1) && mo_pv <= 2 * (nl_pv - 1) && Dh >= 1 &&
         Dh <= 128 && Hkv >= 1 && H % Hkv == 0 && bs >= 1 && W >= 1 &&
         B <= 65535 && Hkv <= 65535;
}

template <bool LN>
cudaError_t paged_for_dh(PagedArgs p, int64_t B, int64_t Hkv,
                         cudaStream_t st) {
  // 16-byte copies where every pool row starts 16-byte aligned
  const auto al16 = [](const void* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  p.vec = p.Dh % 4 == 0 && al16(p.k) && al16(p.v) && p.k_sb % 4 == 0 &&
          p.k_ss % 4 == 0 && p.k_sh % 4 == 0 && p.v_sb % 4 == 0 &&
          p.v_ss % 4 == 0 && p.v_sh % 4 == 0;
  switch (padded_d(p.Dh)) {
    case 16: return launch_paged<16, LN>(p, (int)B, (int)Hkv, st);
    case 32: return launch_paged<32, LN>(p, (int)B, (int)Hkv, st);
    case 64: return launch_paged<64, LN>(p, (int)B, (int)Hkv, st);
    default: return launch_paged<128, LN>(p, (int)B, (int)Hkv, st);
  }
}

// The checks and the launch of mp_flash_attention_launch; bq: the block's
// query rows (16, 32 or 64), 0 for flash_plan's choice.
int flash_entry(const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                void* o, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t B,
                int64_t S, int64_t T, int64_t H, int64_t Dh, int64_t causal,
                int64_t q_offset, double scale, int64_t nl_qk, int64_t mo_qk,
                int64_t nl_pv, int64_t mo_pv, int64_t bq, void* stream) {
  if (nl_qk < 1 || nl_pv < 1 || mo_qk < 0 || mo_pv < 0 ||
      mo_qk > 2 * (nl_qk - 1) || mo_pv > 2 * (nl_pv - 1) || Dh < 1 ||
      Dh > 192 || B * H > 65535 || q_offset < 0 ||
      (bq != 0 && bq != 16 && bq != 32 && bq != 64) || S > 65535 * WR)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto al16 = [](const void* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  FlashArgs p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<float*>(o),
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              o_sb, o_ss, o_sh, (int)H, (int)S, (int)T, (int)Dh,
              (int)causal, (int)q_offset, (float)scale,
              (int)nl_qk, (int)mo_qk, (int)nl_pv, (int)mo_pv, 0, 0};
  // 16-byte copies where every K and V row starts 16-byte aligned
  p.vec = Dh % 4 == 0 && al16(k) && al16(v) && k_sb % 4 == 0 &&
          k_ss % 4 == 0 && k_sh % 4 == 0 && v_sb % 4 == 0 &&
          v_ss % 4 == 0 && v_sh % 4 == 0;
  return (int)flash_dispatch(p, (int)B, (int)bq,
                             static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// out (B, H, Dh) = paged decode attention of q (B, H, Dh) against the K/V
// pools (n_blocks, bs, Hkv, Dh) through table (B, W) int32 and lengths (B,)
// int32; H = Hkv * n_rep (query head h reads kv head h / n_rep).  Strides in
// elements; the head dim must have unit stride, out is contiguous.  Returns
// the CUDA error of the launch (0 on success).  Allocates nothing and does
// not synchronise.
int mp_paged_attention_launch(
    const void* q, int64_t q_sb, int64_t q_sh, const void* k, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, const void* v, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, const void* table, int64_t t_sb, const void* lengths,
    void* o, int64_t B, int64_t H, int64_t Hkv, int64_t Dh, int64_t bs,
    int64_t W, double scale, int64_t nl_qk, int64_t mo_qk, int64_t nl_pv,
    int64_t mo_pv, void* stream) {
  if (!paged_args_ok(B, H, Hkv, Dh, bs, W, nl_qk, mo_qk, nl_pv, mo_pv))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  PagedArgs p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v),
              static_cast<const int32_t*>(table),
              static_cast<const int32_t*>(lengths), static_cast<float*>(o),
              q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, t_sb,
              (int)H, (int)(H / Hkv), (int)Dh, (int)bs, (int)W,
              (float)scale, (int)nl_qk, (int)mo_qk, (int)nl_pv, (int)mo_pv,
              nullptr, nullptr, nullptr, nullptr, 0, 0};
  return (int)paged_for_dh<false>(p, B, Hkv,
                                  static_cast<cudaStream_t>(stream));
}

// The table columns of one chunk of the paged kernels for a head dim Dh,
// pool blocks of bs positions, n_rep query heads per kv head and limb
// depths (envelopes) nl_qk / nl_pv; 0 where shared memory cannot hold one.
int mp_paged_chunk_cols(int64_t Dh, int64_t bs, int64_t n_rep, int64_t nl_qk,
                        int64_t nl_pv) {
  if (Dh < 1 || Dh > 128 || bs < 1 || n_rep < 1 || nl_qk < 1 || nl_pv < 1)
    return 0;
  PagedArgs p{};
  p.bs = (int)bs;
  p.n_rep = (int)n_rep;
  p.nl_qk = (int)nl_qk;
  p.nl_pv = (int)nl_pv;
  return paged_plan(padded_d(Dh), p) ? p.cols : 0;
}

// mp_paged_attention_launch with per-slot formats: slot b's QK format is
// (lane_qk_n[b], lane_qk_ord[b]) and its PV format (lane_pv_n[b],
// lane_pv_ord[b]), (B,) int32 each on the device, at or below the envelopes
// (nl_qk, mo_qk) and (nl_pv, mo_pv), which size shared memory.  Returns the
// CUDA error of the launch (0 on success).  Allocates nothing and does not
// synchronise.
int mp_mixed_paged_attention_launch(
    const void* q, int64_t q_sb, int64_t q_sh, const void* k, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, const void* v, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, const void* table, int64_t t_sb, const void* lengths,
    void* o, int64_t B, int64_t H, int64_t Hkv, int64_t Dh, int64_t bs,
    int64_t W, double scale, int64_t nl_qk, int64_t mo_qk, int64_t nl_pv,
    int64_t mo_pv, const void* lane_qk_n, const void* lane_qk_ord,
    const void* lane_pv_n, const void* lane_pv_ord, void* stream) {
  if (!paged_args_ok(B, H, Hkv, Dh, bs, W, nl_qk, mo_qk, nl_pv, mo_pv) ||
      lane_qk_n == nullptr || lane_qk_ord == nullptr ||
      lane_pv_n == nullptr || lane_pv_ord == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  PagedArgs p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v),
              static_cast<const int32_t*>(table),
              static_cast<const int32_t*>(lengths), static_cast<float*>(o),
              q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, t_sb,
              (int)H, (int)(H / Hkv), (int)Dh, (int)bs, (int)W,
              (float)scale, (int)nl_qk, (int)mo_qk, (int)nl_pv, (int)mo_pv,
              static_cast<const int32_t*>(lane_qk_n),
              static_cast<const int32_t*>(lane_qk_ord),
              static_cast<const int32_t*>(lane_pv_n),
              static_cast<const int32_t*>(lane_pv_ord), 0, 0};
  return (int)paged_for_dh<true>(p, B, Hkv,
                                 static_cast<cudaStream_t>(stream));
}

// out (B, S, H, Dh) = flash attention of q (B, S, H, Dh) against k / v
// (B, T, H, Dh) with H already GQA-repeated.  Strides in elements; the head
// dim must have unit stride.  Returns the CUDA error of the launch (0 on
// success).  Allocates nothing and does not synchronise.
int mp_flash_attention_launch(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh, const void* k,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, const void* v, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, void* o, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int64_t B, int64_t S, int64_t T, int64_t H, int64_t Dh,
    int64_t causal, int64_t q_offset, double scale, int64_t nl_qk,
    int64_t mo_qk, int64_t nl_pv, int64_t mo_pv, void* stream) {
  return flash_entry(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss,
                     v_sh, o, o_sb, o_ss, o_sh, B, S, T, H, Dh, causal,
                     q_offset, scale, nl_qk, mo_qk, nl_pv, mo_pv, 0, stream);
}

// mp_flash_attention_launch with the block's query rows given: bq = 16, 32
// or 64 (they change no bit; the tests launch each).
int mp_flash_attention_launch_bq(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh, const void* k,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, const void* v, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, void* o, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int64_t B, int64_t S, int64_t T, int64_t H, int64_t Dh,
    int64_t causal, int64_t q_offset, double scale, int64_t nl_qk,
    int64_t mo_qk, int64_t nl_pv, int64_t mo_pv, int64_t bq, void* stream) {
  if (bq == 0) return (int)cudaErrorInvalidValue;
  return flash_entry(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss,
                     v_sh, o, o_sb, o_ss, o_sh, B, S, T, H, Dh, causal,
                     q_offset, scale, nl_qk, mo_qk, nl_pv, mo_pv, bq, stream);
}

// Dynamic shared memory of one flash block of bq query rows (flash_smem's
// total) for head dim Dh at these formats: the instantiation's plane
// element sizes (f32 at the serving formats and Dh 64, else bf16).
int64_t mp_flash_smem_bytes(int64_t Dh, int64_t bq, int64_t nl_qk,
                            int64_t mo_qk, int64_t nl_pv, int64_t mo_pv) {
  if (Dh < 1 || Dh > 192 || nl_qk < 1 || nl_pv < 1) return 0;
  const int D = padded_d(Dh);
  const bool sp = flash_special(D, (int)nl_qk, (int)mo_qk, (int)nl_pv,
                                (int)mo_pv);
  return flash_smem(D, (int)bq, (int)nl_qk, (int)nl_pv, sp ? 4 : 2,
                    sp ? 4 : 2)
      .total;
}

// The query rows of one flash block that mp_flash_attention_launch takes
// for B x S x H heads of head dim Dh at these formats on the current
// device (0 where shared memory cannot hold 16 rows), and whether the
// launch runs an instantiation with its formats fixed at compile time
// (*special).
int mp_flash_block_q(int64_t B, int64_t S, int64_t H, int64_t Dh,
                     int64_t nl_qk, int64_t mo_qk, int64_t nl_pv,
                     int64_t mo_pv, int* special) {
  if (Dh < 1 || Dh > 192 || nl_qk < 1 || nl_pv < 1 || S < 1) return 0;
  FlashArgs p{};
  p.S = (int)S;
  p.nl_qk = (int)nl_qk;
  p.nl_pv = (int)nl_pv;
  const int D = padded_d(Dh);
  const bool sp = flash_special(D, (int)nl_qk, (int)mo_qk, (int)nl_pv,
                                (int)mo_pv);
  if (special) *special = sp;
  return flash_plan(D, sp ? 4 : 2, sp ? 4 : 2, B * H, sm_count(), p)
             ? p.bq : 0;
}

}  // extern "C"
