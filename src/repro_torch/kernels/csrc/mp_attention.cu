// Multi-precision flash attention and paged decode attention for Hopper
// (sm_90a), plain C interface.  paged_kernel and mixed_paged_kernel (below
// flash_kernel) replace _paged_kernel and _mixed_paged_kernel; their own
// comments say how.
//
// flash_kernel replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/mp_attention.py (entered there through
// mp_attention_pallas).  One block per (b*h, q tile of BQ rows) walks the kv
// tiles of BKV positions in order:
//
//   q is scaled by `scale` in f32 BEFORE it is limbed;
//   logits = Q K^T at fmt_qk, masked to -1e30 (T tail, causal);
//   m_new = max(m, rowmax(logits)); p = exp(logits - m_new), re-zeroed where
//   invalid; alpha = exp(m - m_new); d = d * alpha + sum(p);
//   acc = acc * alpha + P V at fmt_pv, where P itself is limbed (at M8 it is
//   rounded to bf16);
//   out = acc / max(d, 1e-30).
//
// Both contractions follow the oracle's _matmul_limbs discipline, not
// _combine_orders: each kept limb pair (i, j) is its own full dot product;
// at <= 3 limbs the products are added plainly in `products` order (highest
// order first, i ascending within an order), above 3 limbs the products of
// one order are summed and the order sums are joined by a Neumaier sum.
// kv tiles entirely above the causal diagonal are skipped; q_offset shifts
// the query positions.  The head dim is not padded beyond the tensor's own
// (Dh = 64 runs D = 64).
//
// What bounds it on this card, and what the design does about it: at the
// serving prefill shape (8 x 256 x 12 heads x 64) the work is the limb
// products of the two contractions, done here with f32 FMAs on the CUDA
// cores over bf16 limbs kept in shared memory; Q, K and V are read from
// device memory once per tile and P never leaves shared memory.  The limb
// planes use padded rows (D + 2 bf16) so the 32 lanes of a warp reading 32
// different rows hit 32 different banks.  Tensor-core MMA is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false (no
// --use_fast_math): expf is the accurate one, and d * alpha + sum(p) and
// acc * alpha + pv round twice, as in the PyTorch plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;             // query rows per block
constexpr int BKV = 32;            // kv positions per tile
constexpr int NT = 128;            // threads per block
constexpr int PS = BKV + 2;        // padded row of a P limb plane (bf16)
constexpr int SS = BKV + 1;        // padded row of the logits tile (f32)
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;   // per-block shared memory on sm_90

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
};

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

__device__ __forceinline__ float limb_dot(const __nv_bfloat16* x, int xstep,
                                          const __nv_bfloat16* y, int ystep,
                                          int len) {
  float acc = 0.f;
  for (int e = 0; e < len; ++e)
    acc = fmaf(bf(x[e * xstep]), bf(y[e * ystep]), acc);
  return acc;
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

// The limb products of one contraction element (T = float; float2: two
// elements with the same formats) joined under _matmul_limbs' discipline:
// dot(i, j) is the full dot product of limb i of the left operand with limb
// j of the right one.
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

// One element of a limb contraction under _matmul_limbs' discipline.
// x: limb planes of the left operand's row (plane stride xplane, element
// stride xstep); y likewise for the right operand's column.
__device__ float contract(const __nv_bfloat16* x, int xplane, int xstep,
                          const __nv_bfloat16* y, int yplane, int ystep,
                          int len, int nl, int mo) {
  return combine(nl, mo, [&](int i, int j) {
    return limb_dot(x + i * xplane, xstep, y + j * yplane, ystep, len);
  });
}

template <int D>
__global__ void __launch_bounds__(NT) flash_kernel(FlashArgs p) {
  constexpr int DS = D + 2;              // padded row of a Q/K/V limb plane
  constexpr int OUT_PER_THREAD = BQ * D / NT;
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);   // BQ x SS logits / probs
  float* m_s = Ss + BQ * SS;
  float* d_s = m_s + BQ;
  float* al_s = d_s + BQ;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(al_s + BQ);
  __nv_bfloat16* Ks = Qs + p.nl_qk * BQ * DS;
  __nv_bfloat16* Vs = Ks + p.nl_qk * BKV * DS;
  __nv_bfloat16* Ps = Vs + p.nl_pv * BKV * DS;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  float* o = p.o + b * p.o_sb + h * p.o_sh;

  // Q tile: scaled in f32, then limbed (rows past S and dims past Dh are 0)
  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D;
    const int dd = idx % D;
    const int s = q0 + r;
    const float x = (s < p.S && dd < p.Dh) ? q[s * p.q_ss + dd] * p.scale : 0.f;
    store_limbs(x, Qs + r * DS + dd, BQ * DS, p.nl_qk);
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    d_s[tid] = 0.f;
  }
  float acc[OUT_PER_THREAD];
#pragma unroll
  for (int u = 0; u < OUT_PER_THREAD; ++u) acc[u] = 0.f;

  const int last_q = p.q_offset + q0 + BQ - 1;
  for (int t0 = 0; t0 < p.T; t0 += BKV) {
    if (p.causal && t0 > last_q) break;  // above the diagonal from here on
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int r = idx / D;
      const int dd = idx % D;
      const int t = t0 + r;
      const bool in = t < p.T && dd < p.Dh;
      store_limbs(in ? k[t * p.k_ss + dd] : 0.f, Ks + r * DS + dd, BKV * DS,
                  p.nl_qk);
      store_limbs(in ? v[t * p.v_ss + dd] : 0.f, Vs + r * DS + dd, BKV * DS,
                  p.nl_pv);
    }
    __syncthreads();

    // logits: lanes of a warp share a query row and take 32 kv columns
    for (int idx = tid; idx < BQ * BKV; idx += NT) {
      const int r = idx / BKV;
      const int c = idx % BKV;
      const int qpos = p.q_offset + q0 + r;
      const int tpos = t0 + c;
      const bool valid = tpos < p.T && (!p.causal || qpos >= tpos);
      const float lg = contract(Qs + r * DS, BQ * DS, 1, Ks + c * DS, BKV * DS,
                                1, D, p.nl_qk, p.mo_qk);
      Ss[r * SS + c] = valid ? lg : NEG_INF;
    }
    __syncthreads();

    // online softmax: one thread per query row
    if (tid < BQ) {
      const int r = tid;
      const int qpos = p.q_offset + q0 + r;
      float mx = NEG_INF;
      for (int c = 0; c < BKV; ++c) mx = fmaxf(mx, Ss[r * SS + c]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = 0; c < BKV; ++c) {
        const int tpos = t0 + c;
        const bool valid = tpos < p.T && (!p.causal || qpos >= tpos);
        const float pr = valid ? expf(Ss[r * SS + c] - m_new) : 0.f;
        sum = sum + pr;
        store_limbs(pr, Ps + r * PS + c, BQ * PS, p.nl_pv);
      }
      const float alpha = expf(m_old - m_new);
      d_s[r] = d_s[r] * alpha + sum;
      m_s[r] = m_new;
      al_s[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V: lanes take neighbouring head dims of one row
#pragma unroll
    for (int u = 0; u < OUT_PER_THREAD; ++u) {
      const int idx = tid + u * NT;
      const int r = idx / D;
      const int dd = idx % D;
      const float pv = contract(Ps + r * PS, BQ * PS, 1, Vs + dd, BKV * DS, DS,
                                BKV, p.nl_pv, p.mo_pv);
      acc[u] = acc[u] * al_s[r] + pv;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < OUT_PER_THREAD; ++u) {
    const int idx = tid + u * NT;
    const int r = idx / D;
    const int dd = idx % D;
    const int s = q0 + r;
    if (s < p.S && dd < p.Dh)
      o[s * p.o_ss + dd] = acc[u] / fmaxf(d_s[r], 1e-30f);
  }
}

template <int D>
cudaError_t launch(const FlashArgs& p, int B, cudaStream_t st) {
  const int64_t bf16_elems =
      (int64_t)p.nl_qk * (BQ + BKV) * (D + 2) + (int64_t)p.nl_pv * BKV * (D + 2) +
      (int64_t)p.nl_pv * BQ * PS;
  const int64_t smem = (int64_t)(BQ * SS + 3 * BQ) * 4 + bf16_elems * 2;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((p.S + BQ - 1) / BQ), (unsigned)(B * p.H), 1);
  flash_kernel<D><<<grid, NT, (size_t)smem, st>>>(p);
  return cudaGetLastError();
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
constexpr unsigned FULL = 0xffffffffu;

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

// the k-th kept limb product (i, j) of a format in products order: highest
// order first, i ascending within an order (combine's order)
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
  int nprod = 0;                         // kept QK limb products
  for (int o = mo_qk; o >= 0; --o)
    nprod += min(o, nl_qk - 1) - max(0, o - (nl_qk - 1)) + 1;
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

int paged_d(int64_t Dh) {
  return Dh <= 16 ? 16 : Dh <= 32 ? 32 : Dh <= 64 ? 64 : 128;
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
  switch (paged_d(p.Dh)) {
    case 16: return launch_paged<16, LN>(p, (int)B, (int)Hkv, st);
    case 32: return launch_paged<32, LN>(p, (int)B, (int)Hkv, st);
    case 64: return launch_paged<64, LN>(p, (int)B, (int)Hkv, st);
    default: return launch_paged<128, LN>(p, (int)B, (int)Hkv, st);
  }
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
  return paged_plan(paged_d(Dh), p) ? p.cols : 0;
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
  if (nl_qk < 1 || nl_pv < 1 || mo_qk < 0 || mo_pv < 0 ||
      mo_qk > 2 * (nl_qk - 1) || mo_pv > 2 * (nl_pv - 1) || Dh < 1 ||
      Dh > 128 || B * H > 65535 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  FlashArgs p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<float*>(o),
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              o_sb, o_ss, o_sh, (int)H, (int)S, (int)T, (int)Dh,
              (int)causal, (int)q_offset, (float)scale,
              (int)nl_qk, (int)mo_qk, (int)nl_pv, (int)mo_pv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Dh <= 16) err = launch<16>(p, (int)B, st);
  else if (Dh <= 32) err = launch<32>(p, (int)B, st);
  else if (Dh <= 64) err = launch<64>(p, (int)B, st);
  else err = launch<128>(p, (int)B, st);
  return (int)err;
}

}  // extern "C"
