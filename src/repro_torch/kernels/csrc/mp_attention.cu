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

// One element of a limb contraction under _matmul_limbs' discipline.
// x: limb planes of the left operand's row (plane stride xplane, element
// stride xstep); y likewise for the right operand's column.
__device__ float contract(const __nv_bfloat16* x, int xplane, int xstep,
                          const __nv_bfloat16* y, int yplane, int ystep,
                          int len, int nl, int mo) {
  float out = 0.f, s = 0.f, c = 0.f;
  bool first = true;
  int n_orders = 0;
  for (int o = mo; o >= 0; --o) {
    float osum = 0.f;
    bool ofirst = true;
    const int ilo = o - (nl - 1) > 0 ? o - (nl - 1) : 0;
    const int ihi = o < nl - 1 ? o : nl - 1;
    for (int i = ilo; i <= ihi; ++i) {
      const int j = o - i;
      const float pr = limb_dot(x + i * xplane, xstep, y + j * yplane, ystep,
                                len);
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
        const float tmp = s + osum;
        c = c + ((fabsf(s) >= fabsf(osum)) ? ((s - tmp) + osum)
                                           : ((osum - tmp) + s));
        s = tmp;
      }
      ++n_orders;
    }
  }
  if (nl <= 3) return out;
  return n_orders == 1 ? s : s + c;
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
};

// Replaces the Pallas TPU kernel _paged_kernel of
// src/repro/kernels/mp_attention.py (entered there through
// mp_paged_attention_pallas): one decode query per slot against the paged
// KV pool.  One block per (kv head, slot) serves the n_rep query heads that
// share the kv head.  It walks the slot's table columns j with
// j * bs < length (at most W of them), reads pool block table[b, j] straight
// from the pool (no pool[table] gather in device memory), and folds each
// block into the running (max, denominator, accumulator) with one
// online-softmax update, as the TPU kernel's grid column does: logits = Q K^T
// at fmt_qk (q scaled in f32 before it is limbed), masked to -1e30 past the
// length; p = exp(logits - m_new) re-zeroed past the length; P limbed at
// fmt_pv for P V.  A slot of length 0 writes exact zeros (d clamped to
// 1e-30, acc 0).  Contractions follow _matmul_limbs (contract above), like
// flash_kernel.
//
// What bounds it on this card: at the decode shape (8 slots, 12 heads,
// Dh 64, lengths up to ~300) the bytes of the K/V blocks below each slot's
// length; each is read from device memory once per (slot, kv head) and
// limbed once in shared memory for all n_rep query heads.  Small work per
// block (bs positions): later work can split a slot's columns across blocks.
//
// LN (mixed_paged_kernel): slot b runs at its own QK and PV lane formats,
// four values the block reads from the lane vectors before it starts.
// Shared memory is laid out for the envelopes (p.nl_qk, p.nl_pv), Q, K, V
// and P are limbed to the slot's own depth, and contract() runs at the
// slot's formats, so a slot's output is bitwise paged_kernel's at the
// slot's formats (lanes are clamped to the envelope, which keeps a bad lane
// inside shared memory).
template <int D, bool LN>
__device__ __forceinline__ void paged_body(const PagedArgs& p) {
  constexpr int DS = D + 2;              // padded row of a Q/K/V limb plane
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int nr = p.n_rep;
  const int bs = p.bs;
  const int ps = bs + 2;                 // padded row of a P limb plane
  const int ss = bs + 1;                 // padded row of the logits tile
  int nl_qk = p.nl_qk, mo_qk = p.mo_qk, nl_pv = p.nl_pv, mo_pv = p.mo_pv;
  if constexpr (LN) {
    nl_qk = max(1, min(p.lane_qk_n[b], p.nl_qk));
    mo_qk = max(0, min(p.lane_qk_ord[b], min(p.mo_qk, 2 * (nl_qk - 1))));
    nl_pv = max(1, min(p.lane_pv_n[b], p.nl_pv));
    mo_pv = max(0, min(p.lane_pv_ord[b], min(p.mo_pv, 2 * (nl_pv - 1))));
  }
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);   // nr x ss logits / probs
  float* acc_s = Ss + nr * ss;                   // nr x D accumulators
  float* m_s = acc_s + nr * D;
  float* d_s = m_s + nr;
  float* al_s = d_s + nr;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(al_s + nr);
  __nv_bfloat16* Ks = Qs + p.nl_qk * nr * DS;
  __nv_bfloat16* Vs = Ks + p.nl_qk * bs * DS;
  __nv_bfloat16* Ps = Vs + p.nl_pv * bs * DS;

  const int tid = threadIdx.x;
  const float* q = p.q + b * p.q_sb + (int64_t)kvh * nr * p.q_sh;
  for (int idx = tid; idx < nr * D; idx += NT) {
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
  const int length = p.lengths[b];
  int ncol = (length + bs - 1) / bs;
  if (ncol > p.W) ncol = p.W;
  for (int j = 0; j < ncol; ++j) {
    __syncthreads();  // the previous block's readers are done
    const int64_t blk = p.table[b * p.t_sb + j];
    const float* kb = p.k + blk * p.k_sb + kvh * p.k_sh;
    const float* vb = p.v + blk * p.v_sb + kvh * p.v_sh;
    for (int idx = tid; idx < bs * D; idx += NT) {
      const int t = idx / D;
      const int dd = idx % D;
      const bool in = dd < p.Dh;
      store_limbs(in ? kb[t * p.k_ss + dd] : 0.f, Ks + t * DS + dd, bs * DS,
                  nl_qk);
      store_limbs(in ? vb[t * p.v_ss + dd] : 0.f, Vs + t * DS + dd, bs * DS,
                  nl_pv);
    }
    __syncthreads();

    for (int idx = tid; idx < nr * bs; idx += NT) {
      const int r = idx / bs;
      const int c = idx % bs;
      const float lg = contract(Qs + r * DS, nr * DS, 1, Ks + c * DS, bs * DS,
                                1, D, nl_qk, mo_qk);
      Ss[r * ss + c] = (j * bs + c < length) ? lg : NEG_INF;
    }
    __syncthreads();

    // online softmax: one thread per query head
    if (tid < nr) {
      const int r = tid;
      float mx = NEG_INF;
      for (int c = 0; c < bs; ++c) mx = fmaxf(mx, Ss[r * ss + c]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = 0; c < bs; ++c) {
        const float pr =
            (j * bs + c < length) ? expf(Ss[r * ss + c] - m_new) : 0.f;
        sum = sum + pr;
        store_limbs(pr, Ps + r * ps + c, nr * ps, nl_pv);
      }
      const float alpha = expf(m_old - m_new);
      d_s[r] = d_s[r] * alpha + sum;
      m_s[r] = m_new;
      al_s[r] = alpha;
    }
    __syncthreads();

    for (int idx = tid; idx < nr * D; idx += NT) {
      const int r = idx / D;
      const int dd = idx % D;
      const float pv = contract(Ps + r * ps, nr * ps, 1, Vs + dd, bs * DS, DS,
                                bs, nl_pv, mo_pv);
      acc_s[idx] = acc_s[idx] * al_s[r] + pv;
    }
  }
  __syncthreads();
  float* o = p.o + ((int64_t)b * p.H + (int64_t)kvh * nr) * p.Dh;
  for (int idx = tid; idx < nr * D; idx += NT) {
    const int r = idx / D;
    const int dd = idx % D;
    if (dd < p.Dh) o[r * p.Dh + dd] = acc_s[idx] / fmaxf(d_s[r], 1e-30f);
  }
}

template <int D>
__global__ void __launch_bounds__(NT) paged_kernel(PagedArgs p) {
  paged_body<D, false>(p);
}

// Replaces the Pallas TPU kernel _mixed_paged_kernel of
// src/repro/kernels/mp_attention.py (entered there through
// mp_mixed_paged_attention_pallas): paged_kernel for a decode micro-batch
// whose slots run different formats, in one launch.  Slot b's QK and PV
// formats are (lane_qk_n[b], lane_qk_ord[b]) and (lane_pv_n[b],
// lane_pv_ord[b]) at or below the envelopes; the TPU kernel runs the
// envelope's limb loops and masks a slot's surplus products to +0.0, this
// one limbs and contracts at the slot's own depth, which leaves the same
// products out and adds no zeros.  Bound like paged_kernel.
template <int D>
__global__ void __launch_bounds__(NT) mixed_paged_kernel(PagedArgs p) {
  paged_body<D, true>(p);
}

template <int D, bool LN>
cudaError_t launch_paged(const PagedArgs& p, int B, int Hkv,
                         cudaStream_t st) {
  const int64_t nr = p.n_rep;
  const int64_t bf16_elems = (int64_t)p.nl_qk * (nr + p.bs) * (D + 2) +
                             (int64_t)p.nl_pv * p.bs * (D + 2) +
                             (int64_t)p.nl_pv * nr * (p.bs + 2);
  const int64_t smem = (nr * (p.bs + 1) + nr * D + 3 * nr) * 4 +
                       bf16_elems * 2;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto* kern = LN ? mixed_paged_kernel<D> : paged_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)Hkv, (unsigned)B, 1);
  kern<<<grid, NT, (size_t)smem, st>>>(p);
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
cudaError_t paged_for_dh(const PagedArgs& p, int64_t B, int64_t Hkv,
                         cudaStream_t st) {
  if (p.Dh <= 16) return launch_paged<16, LN>(p, (int)B, (int)Hkv, st);
  if (p.Dh <= 32) return launch_paged<32, LN>(p, (int)B, (int)Hkv, st);
  if (p.Dh <= 64) return launch_paged<64, LN>(p, (int)B, (int)Hkv, st);
  return launch_paged<128, LN>(p, (int)B, (int)Hkv, st);
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
              nullptr, nullptr, nullptr, nullptr};
  return (int)paged_for_dh<false>(p, B, Hkv,
                                  static_cast<cudaStream_t>(stream));
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
              static_cast<const int32_t*>(lane_pv_ord)};
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
