"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, and the SMOKE engine on the card against
the same engine on the CPU.

    python -m pytest -m gpu tests/test_torch_gpu.py

Every test here needs a CUDA card; the ``cuda`` fixture decides at run time
and skips without one (so the module collects the same tests everywhere).
Tolerances: kernel and plain version sum the same exact limb products in
another order, so matmuls are held at the repo's f32 accumulation floor
(8 * 2^-24 * sqrt(K) of the output's scale, tests/test_kernels.py) plus
rtol 2e-6, and attention at tests/test_mp_attention.py's same-blocking
2e-5.  This module imports no jax: the machine with the card need not have
it."""
import math

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import paper_mpfp
from repro_torch.core.formats import register_format, resolve, \
    unregister_format
from repro_torch.kernels import build, mp_attention, mp_matmul
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu

CUSTOM = "M28GPU"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest -m gpu "
                    "tests/test_torch_gpu.py on the machine with one)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def custom_format():
    fmt = register_format(CUSTOM, mantissa_bits=28, n_limbs=4, max_order=3)
    yield fmt
    unregister_format(CUSTOM)


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev)


def _floor(ref, K):
    rms = ref.pow(2).mean().sqrt()
    return 2e-6 * ref.abs() + 8 * 2.0 ** -24 * math.sqrt(K) * rms


def _assert_within(out, ref, tol):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert ((out - ref).abs() <= tol).all(), (out - ref).abs().max().item()


def _assert_mm_close(out, ref, K):
    _assert_within(out, ref, _floor(ref, K))


@pytest.mark.parametrize("M,K,N", [(130, 200, 70), (8, 768, 768)])
@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M36", "M52", CUSTOM])
def test_fused_matmul_kernel_matches_plain(cuda, custom_format, mode, M, K,
                                           N):
    a, b = _randn(cuda, M, K, seed=1), _randn(cuda, K, N, seed=2)
    before = mp_matmul.mp_fused_matmul.launches
    out = mp_matmul.mp_fused_matmul(a, b, mode)
    assert mp_matmul.mp_fused_matmul.launches == before + 1
    _assert_mm_close(out, mp_matmul.fused_matmul_plain(a, b, mode), K)


@pytest.mark.parametrize("M,K,N", [(130, 200, 70), (8, 768, 768),
                                   (1, 77, 33)])
@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M36", "M52", CUSTOM])
def test_partials_epilogue_matches_plain_and_combines_to_fused(
        cuda, custom_format, mode, M, K, N):
    """The partials epilogue: each order's plane against the plain stack,
    ``combine_partials`` of the stack bitwise the fused kernel (both
    tiles), one launch; a K-slice view read in place."""
    from repro_torch.kernels import ref

    a, b = _randn(cuda, M, K, seed=1), _randn(cuda, K, N, seed=2)
    before = mp_matmul.mp_fused_matmul_partials.launches
    parts = mp_matmul.mp_fused_matmul_partials(a, b, mode)
    assert mp_matmul.mp_fused_matmul_partials.launches == before + 1
    plain = mp_matmul.fused_matmul_partials_plain(a, b, mode)
    assert parts.shape == (resolve(mode).n_orders, M, N)
    for o in range(parts.shape[0]):
        _assert_mm_close(parts[o], plain[o], K)
    fused = mp_matmul.mp_fused_matmul(a, b, mode)
    torch.cuda.synchronize()
    assert torch.equal(ref.combine_partials(parts, mode).view(torch.int32),
                       fused.view(torch.int32))
    half = K // 2
    view = mp_matmul.mp_fused_matmul_partials(a[:, half:], b[half:], mode)
    copy = mp_matmul.mp_fused_matmul_partials(a[:, half:].contiguous(),
                                              b[half:].contiguous(), mode)
    torch.cuda.synchronize()
    assert torch.equal(view.view(torch.int32), copy.view(torch.int32))


@pytest.mark.parametrize("mode", ["M8", "M16"])
def test_batched_strided_matmul_is_one_launch(cuda, mode):
    """Decode attention's QK: q (B, H, 1, Dh) against the cache read as a
    transposed view, broadcast over nothing, strided over (B, H)."""
    q = _randn(cuda, 4, 1, 3, 64, seed=3).permute(0, 2, 1, 3)
    kc = _randn(cuda, 4, 100, 3, 64, seed=4)
    kt = kc.permute(0, 2, 1, 3).transpose(-1, -2)
    before = mp_matmul.mp_fused_matmul.launches
    out = mp_matmul.mp_fused_matmul(q, kt, mode)
    assert mp_matmul.mp_fused_matmul.launches == before + 1
    _assert_mm_close(out, mp_matmul.fused_matmul_plain(q, kt, mode), 64)
    a3 = _randn(cuda, 2, 3, 5, 24, seed=5)     # three batch dims
    b3 = _randn(cuda, 1, 3, 24, 9, seed=6)     # one broadcast
    _assert_mm_close(mp_matmul.mp_fused_matmul(a3, b3, mode),
                     mp_matmul.fused_matmul_plain(a3, b3, mode), 24)


@pytest.mark.parametrize("n_out", [1, 2, 3])
@pytest.mark.parametrize("mode", ["M8", "M16", "M36", CUSTOM])
def test_fused_proj_kernel_matches_plain(cuda, custom_format, mode, n_out):
    a = _randn(cuda, 77, 96, seed=7)
    ws = [_randn(cuda, 96, 50, seed=8 + t) for t in range(n_out)]
    bs = [_randn(cuda, 50, seed=20 + t) for t in range(n_out)]
    res = _randn(cuda, 77, 50, seed=30) if n_out == 1 else None
    out = mp_matmul.mp_fused_proj(a, ws, mode, biases=bs, residual=res)
    ref = mp_matmul.fused_proj_plain(a, ws, mode, biases=bs, residual=res)
    _assert_mm_close(out, ref, 96)


@pytest.mark.parametrize("mode", ["M8", "M23"])
def test_swiglu_epilogue_matches_plain(cuda, mode):
    a = _randn(cuda, 64, 128, seed=40)
    ws = [_randn(cuda, 128, 256, seed=41) * 0.1,
          _randn(cuda, 128, 256, seed=42) * 0.1]
    res = _randn(cuda, 64, 256, seed=43)
    out = mp_matmul.mp_fused_proj(a, ws, mode, gate="swiglu", residual=res)
    ref = mp_matmul.fused_proj_plain(a, ws, mode, gate="swiglu",
                                     residual=res)
    # each raw output's floor, carried through silu(g) * u (|silu'| <= 1.1)
    g, u = mp_matmul.fused_proj_plain(a, ws, mode)
    tol = (1.1 * u.abs() * _floor(g, 128)
           + (g / (1 + torch.exp(-g))).abs() * _floor(u, 128)
           + 2e-6 * ref.abs())
    _assert_within(out, ref, tol)


@pytest.mark.parametrize("qk,pv,causal,S,T,q_offset", [
    ("M16", "M8", True, 100, 100, 0),
    ("M8", "M8", False, 33, 70, 0),
    ("M23", "M16", True, 9, 80, 71),
    ("M36", "M52", True, 40, 40, 0),
])
def test_flash_kernel_matches_plain(cuda, qk, pv, causal, S, T, q_offset):
    q = _randn(cuda, 2, S, 3, 64, seed=50)
    k, v = _randn(cuda, 2, T, 3, 64, seed=51), _randn(cuda, 2, T, 3, 64,
                                                       seed=52)
    before = mp_attention.mp_flash_attention.launches
    out = mp_attention.mp_flash_attention(q, k, v, qk, pv, causal=causal,
                                          q_offset=q_offset)
    assert mp_attention.mp_flash_attention.launches == before + 1
    ref = mp_attention.flash_attention_plain(
        q, k, v, resolve(qk), resolve(pv), causal=causal, q_offset=q_offset,
        scale=0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


# =========================================================================
# flash attention: a head's bits do not depend on the batch, the other
# heads or the block's query rows
# =========================================================================
# (B, S, T, H, Dh, causal, q_offset): S and T off the 16/32/64-row blocks
# and the 32-position kv tiles, on both sides of them, q_offset, S != T
FLASH_SHAPES = {
    "causal ragged": (2, 77, 77, 3, 64, True, 0),
    "causal tile edges": (1, 65, 65, 2, 64, True, 0),
    "bidirectional S != T": (2, 33, 70, 2, 64, False, 0),
    "q_offset": (1, 9, 80, 2, 64, True, 71),
    "q_offset ragged": (2, 17, 50, 2, 64, True, 33),
}
SERVING = ("M8", "M16", "M23")
FLASH_FORMATS = ([(qk, pv) for qk in SERVING for pv in SERVING]
                 + [("M36", "M52"), (CUSTOM, "M16")])


def _flash_inputs(cuda, B, S, T, H, Dh, seed):
    return (_randn(cuda, B, S, H, Dh, seed=seed),
            _randn(cuda, B, T, H, Dh, seed=seed + 1),
            _randn(cuda, B, T, H, Dh, seed=seed + 2))


def _flash_at_block_q(q, k, v, qk, pv, causal, q_offset, block_q):
    return mp_attention.launch_flash_attention(
        build.load("mp_attention"),
        torch.cuda.current_stream().cuda_stream, q, k, v, resolve(qk),
        resolve(pv), causal=causal, scale=q.shape[-1] ** -0.5,
        q_offset=q_offset, block_q=block_q)


def _assert_flash_invariant(out, q, k, v, qk, pv, causal, q_offset):
    """``out`` bitwise every block size's launch and, head by head, the
    head launched alone (B = H = 1)."""
    torch.cuda.synchronize()
    bits = out.view(torch.int32)
    for bq in mp_attention.FLASH_BLOCK_QS:
        other = _flash_at_block_q(q, k, v, qk, pv, causal, q_offset, bq)
        torch.cuda.synchronize()
        assert torch.equal(bits, other.view(torch.int32)), bq
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            one = mp_attention.mp_flash_attention(
                q[b:b + 1, :, h:h + 1], k[b:b + 1, :, h:h + 1],
                v[b:b + 1, :, h:h + 1], qk, pv, causal=causal,
                q_offset=q_offset)
            torch.cuda.synchronize()
            assert torch.equal(bits[b:b + 1, :, h:h + 1],
                               one.view(torch.int32)), (b, h)


@pytest.mark.parametrize("fmts", FLASH_FORMATS,
                         ids=[f"{a}/{b}" for a, b in FLASH_FORMATS])
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_heads_are_invariant(cuda, custom_format, shape, fmts):
    """Every serving format pair (the compile-time instantiations), M36/M52
    and a custom format (the generic one): the kernel within 2e-5 of its
    plain version, and each head's bits independent of the block's query
    rows and of the other heads and batch rows."""
    B, S, T, H, Dh, causal, q_offset = FLASH_SHAPES[shape]
    qk, pv = fmts
    q, k, v = _flash_inputs(cuda, B, S, T, H, Dh, seed=80)
    out = mp_attention.mp_flash_attention(q, k, v, qk, pv, causal=causal,
                                          q_offset=q_offset)
    ref = mp_attention.flash_attention_plain(
        q, k, v, resolve(qk), resolve(pv), causal=causal, q_offset=q_offset,
        scale=Dh ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    _assert_flash_invariant(out, q, k, v, qk, pv, causal, q_offset)


@pytest.mark.parametrize("fmts", [("M16", "M8"), ("M23", "M23")])
@pytest.mark.parametrize("dh", [16, 24, 32, 64, 80, 96, 100, 128, 160, 192])
def test_flash_head_dims(cuda, dh, fmts):
    """Head dims 16..192 (Dh off 16, 32, 64, 128, 192 among them: the dims
    past Dh are zero; 80 and 96 are zamba2's / hubert's and minicpm3's, 192
    MLA's 128 + 64), against the plain version and invariant as above."""
    qk, pv = fmts
    q, k, v = _flash_inputs(cuda, 2, 45, 45, 2, dh, seed=90)
    out = mp_attention.mp_flash_attention(q, k, v, qk, pv)
    ref = mp_attention.flash_attention_plain(q, k, v, resolve(qk),
                                             resolve(pv), scale=dh ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    _assert_flash_invariant(out, q, k, v, qk, pv, True, 0)


def test_flash_strided_heads_and_unaligned_rows(cuda):
    """q, k, v read in place through their strides: heads of a fused QKV
    output, and K/V rows that do not start 16-byte aligned (element copies)
    give the bits of contiguous copies."""
    qkv = _randn(cuda, 2, 40, 3, 2, 64, seed=95)
    q, k, v = qkv.unbind(2)
    out = mp_attention.mp_flash_attention(q, k, v, "M16", "M8")
    same = mp_attention.mp_flash_attention(q.contiguous(), k.contiguous(),
                                           v.contiguous(), "M16", "M8")
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), same.view(torch.int32))
    raw = _randn(cuda, 2 * 40 * 2 * 64 + 1, seed=96)
    ku = raw[1:].view(2, 40, 2, 64)          # rows 4 bytes off 16
    odd = mp_attention.mp_flash_attention(q, ku, v, "M16", "M8")
    even = mp_attention.mp_flash_attention(q, ku.clone(), v, "M16", "M8")
    torch.cuda.synchronize()
    assert torch.equal(odd.view(torch.int32), even.view(torch.int32))


def test_flash_block_q_rule(cuda):
    """The library's rows per block: the largest of 64, 32, 16 whose grid
    reaches the SM count, 16 where none does, and the serving formats at
    Dh 64 on the compile-time instantiation."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, H in ((8, 256, 12), (1, 256, 12), (1, 64, 12), (2, 256, 12),
                    (64, 64, 12)):
        want = next((bq for bq in (64, 32) if B * H * -(-S // bq) >= n_sm),
                    16)
        assert mp_attention.flash_block_q(B, S, H, 64, "M16", "M8") == (
            want, True), (B, S, H)
    assert mp_attention.flash_block_q(1, 70, 2, 64, "M36", "M52")[1] is False
    assert mp_attention.flash_block_q(1, 70, 2, 128, "M16", "M8")[1] is False
    # MLA's head dim: the generic instantiation, 64 rows at the prefill grid
    assert mp_attention.flash_block_q(8, 256, 16, 192, "M16", "M8") == (
        64, False)


def test_flash_mla_prefill_shape(cuda):
    """deepseek-v2-lite's prefill attention (V padded to the QK head dim
    192) at 4 of its 16 heads: within 2e-5 of the plain version, every head
    bitwise the head launched alone."""
    q, k, v = _flash_inputs(cuda, 2, 256, 256, 4, 192, seed=97)
    v[..., 128:] = 0.0
    out = mp_attention.mp_flash_attention(q, k, v, "M16", "M8")
    ref = mp_attention.flash_attention_plain(q, k, v, resolve("M16"),
                                             resolve("M8"), scale=192 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    assert torch.equal(out[..., 128:], torch.zeros_like(out[..., 128:]))
    _assert_flash_invariant(out, q, k, v, "M16", "M8", True, 0)


@pytest.mark.parametrize("mode", ["M8", "M16", "M23"])
def test_batched_expert_launch_is_the_per_expert_loop(cuda, mode):
    """The MoE experts' contraction: (T, D) tokens broadcast against the
    stacked (E, D, F) weights in ONE launch, each expert's slice bitwise
    its lone launch, at a prefill and a decode token count."""
    w = _randn(cuda, 8, 256, 176, seed=98)
    for T in (300, 8):
        x = _randn(cuda, T, 256, seed=99)
        before = mp_matmul.mp_fused_matmul.launches
        out = mp_matmul.mp_fused_matmul(x, w, mode)
        assert mp_matmul.mp_fused_matmul.launches == before + 1
        for e in range(w.shape[0]):
            one = mp_matmul.mp_fused_matmul(x, w[e], mode)
            torch.cuda.synchronize()
            assert torch.equal(out[e].view(torch.int32),
                               one.view(torch.int32)), (T, e)


@pytest.mark.parametrize("mode", ["M8", "M16"])
def test_batched_expert_backward_shapes_are_the_per_expert_loop(cuda, mode):
    """The experts' backward launches: the dgrad (E, T, F) against the
    (E, F, D) transposed view of the stacked weights, and the 3-D wgrad
    x^T (a stride-0 batch) against (E, T, F): each one launch, each
    expert's slice bitwise its lone launch on contiguous copies."""
    w = _randn(cuda, 8, 256, 176, seed=101)
    g = _randn(cuda, 8, 300, 176, seed=102)
    x = _randn(cuda, 300, 256, seed=103)
    for a, b in ((g, w.transpose(-1, -2)), (x.t(), g)):
        before = mp_matmul.mp_fused_matmul.launches
        out = mp_matmul.mp_fused_matmul(a, b, mode)
        assert mp_matmul.mp_fused_matmul.launches == before + 1
        for e in range(w.shape[0]):
            ae = (a if a.ndim == 2 else a[e]).contiguous()
            one = mp_matmul.mp_fused_matmul(ae, b[e].contiguous(), mode)
            torch.cuda.synchronize()
            assert torch.equal(out[e].view(torch.int32),
                               one.view(torch.int32)), e


# the cuda route's distance from the ref backend on one full-width MLA
# layer, in the norm: set from the card's readings, between the sound run
# (9.08e-4 on an H100) and the same layer with its QK one format lower, M8
# where M16 is asked (3.10e-3)
MLA_LAYER_TOL = 1.5e-3


def test_full_width_mla_layer_prefill_matches_ref(cuda):
    """One deepseek-v2-lite MLA attention layer at full width (d_model
    2048, 16 heads, kv_lora 512, qk 128 + 64, v 128) over 2 x 128 tokens
    under serve_default: the cuda route (fused projections, flash at Dh
    192) within MLA_LAYER_TOL of the ref backend in the norm, and the same
    layer with ``attn_logits`` at M8 past it (the control)."""
    import repro_torch.mp as mp
    from repro_torch.configs import deepseek_v2_lite_16b
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import mla

    dims = deepseek_v2_lite_16b.CONFIG.mla
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = mla.init_mla_params(gen, dims, cuda)
    x = _randn(cuda, 2, 128, dims.d_model, seed=100)
    pol = PrecisionPolicy.serve_default()
    kernels.reset_launch_counts()
    with torch.no_grad():
        out, _ = mla.mla_forward(params, x, dims, pol)
        assert kernels.launch_counts()["mp_flash_attention"] == 1
        assert not any(kernels.plain_call_counts().values())
        low, _ = mla.mla_forward(params, x, dims,
                                 pol.overlay({"attn_logits": "M8"}))
        with mp.context(backend="ref"):
            ref, _ = mla.mla_forward(params, x, dims, pol)
    torch.cuda.synchronize()
    rel = ((out - ref).norm() / ref.norm()).item()
    ctl = ((low - ref).norm() / ref.norm()).item()
    print(f"MLA layer vs ref: {rel:.4e}; QK at M8: {ctl:.4e}")
    assert torch.isfinite(out).all() and rel <= MLA_LAYER_TOL < ctl, \
        (rel, ctl)


def test_smoke_engine_on_the_card_matches_the_cpu(cuda):
    """The whole slice on the card launches every kernel and agrees with
    the plain versions on the CPU at M8's error budget."""
    cfg = paper_mpfp.SMOKE
    params = T.init_params(cfg, seed=0)
    gpu = ServeEngine(cfg, params, max_batch=2, max_seq=48)
    cpu = ServeEngine(cfg, params, max_batch=2, max_seq=48, device="cpu")
    prompts = [np.arange(1, 14), np.asarray([5, 6, 7])]
    toks = gpu.pad_prompts(prompts)
    kernels.reset_launch_counts()
    lg, _ = gpu.prefill(toks, gpu.make_cache())
    lc, _ = cpu.prefill(toks, cpu.make_cache())
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(kernels.KERNELS, 0),
                      "mp_fused_matmul": 5, "mp_fused_proj": 4,
                      "mp_flash_attention": 2}, counts
    scale = lc.abs().max().item()
    assert (lg.cpu() - lc).abs().max().item() <= \
        resolve("M8").rel_err_bound * scale
    assert len(gpu.generate(prompts, max_new=4)[0]) == 4


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
def test_decompose_kernel_is_bitwise_the_plain_version(cuda, n_limbs):
    w = _randn(cuda, 37, 300, seed=60)
    w[0, :3] = torch.tensor([0.0, -0.0, 1e-30], device=cuda)
    before = mp_matmul.mp_decompose.launches
    out = mp_matmul.mp_decompose(w, n_limbs)
    assert mp_matmul.mp_decompose.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16),
                       mp_matmul.decompose_plain(w, n_limbs)
                       .view(torch.int16))


@pytest.mark.parametrize("M,K,N", [(70, 200, 90), (8, 768, 768)])
@pytest.mark.parametrize("mode,n_stored", [
    ("M8", 1), ("M8", 2), ("M16", 1), ("M16", 2), ("M23", 4), ("M36", 3),
    (CUSTOM, 4)])
def test_prelimbed_kernel_matches_plain_and_fused(cuda, custom_format, mode,
                                                  n_stored, M, K, N):
    """Held at the f32 floor against the plain version, and bitwise against
    the fused kernel on the raw weight whenever the stack holds every limb
    the format needs."""
    a, w = _randn(cuda, M, K, seed=61), _randn(cuda, K, N, seed=62)
    limbs = mp_matmul.mp_decompose(w, n_stored)
    before = mp_matmul.mp_prelimbed_matmul.launches
    out = mp_matmul.mp_prelimbed_matmul(a, limbs, mode)
    assert mp_matmul.mp_prelimbed_matmul.launches == before + 1
    _assert_mm_close(out, mp_matmul.prelimbed_matmul_plain(a, limbs, mode),
                     K)
    if n_stored >= resolve(mode).n_limbs:
        assert torch.equal(out, mp_matmul.mp_fused_matmul(a, w, mode))


# =========================================================================
# the decode tile (M <= 16 rows): a row's bits do not depend on the tile
# =========================================================================
BATCH_MS = (1, 2, 3, 4, 8, 16, 17)
# (K, N, lda): K off the 64-k chunk of both tiles and off a stage, N
# off the decode tile's 16 columns, A's rows lda apart; the first takes
# 16-byte copies of A and B (N a multiple of 8), the second copies B element
# by element, the third copies A element by element (its rows 201 apart),
# the fourth ends each row of A in a partial 16-byte chunk (201 columns of a
# 204-wide tensor)
DECODE_KN = [(200, 88, 200), (304, 77, 304), (201, 88, 201), (201, 88, 204)]


def _underflow_row(a, b):
    """Row 0 of a and column 0 of b tiny, so C[0, 0]'s products underflow
    and its sums end at +0.0 or -0.0: the zero signs both tiles leave are
    part of the bits held."""
    a[0] *= 1e-30
    b[:, 0] *= 1e-30


def _rows_of(cuda, M, K, lda, seed):
    """(M, K) rows of an (M, lda) tensor: a column slice when lda > K."""
    return _randn(cuda, M, lda, seed=seed)[:, :K]


def _assert_rows_bitwise(out, full, rows, what):
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), full[rows].view(torch.int32)), \
        what


@pytest.mark.parametrize("K,N,lda", DECODE_KN)
@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M36", "M52", CUSTOM])
def test_fused_matmul_rows_are_batch_invariant(cuda, custom_format, mode, K,
                                               N, lda):
    """Rows of a launch at M <= 17 (the decode tile up to 16) equal, bit for
    bit, the same rows of one launch at M = 70 (the prefill tile)."""
    a, b = _rows_of(cuda, 70, K, lda, seed=90), _randn(cuda, K, N, seed=91)
    _underflow_row(a, b)
    full = mp_matmul.mp_fused_matmul(a, b, mode)
    for M in BATCH_MS:
        for rows in (slice(0, M), slice(70 - M, 70)):
            _assert_rows_bitwise(mp_matmul.mp_fused_matmul(a[rows], b, mode),
                                 full, rows, (M, rows))


@pytest.mark.parametrize("mode", ["M8", "M16", CUSTOM])
def test_batched_strided_matmul_rows_are_batch_invariant(cuda, custom_format,
                                                         mode):
    """Decode attention's layouts on a two-dim grid.z batch: QK against the
    cache as a transposed view (B's row stride 1) and PV against the
    cache's strided values, M rows per batch entry against M = 70."""
    q = _randn(cuda, 4, 70, 3, 64, seed=92).permute(0, 2, 1, 3)
    kt = _randn(cuda, 4, 100, 3, 64, seed=93).permute(0, 2, 1, 3) \
        .transpose(-1, -2)
    p = _randn(cuda, 4, 3, 70, 100, seed=94)
    v = _randn(cuda, 4, 100, 3, 64, seed=95).permute(0, 2, 1, 3)
    for x, y in ((q, kt), (p, v)):
        full = mp_matmul.mp_fused_matmul(x, y, mode)
        for M in BATCH_MS:
            rows = (slice(None), slice(None), slice(0, M))
            _assert_rows_bitwise(mp_matmul.mp_fused_matmul(x[rows], y, mode),
                                 full, rows, (tuple(y.shape), M))


@pytest.mark.parametrize("K,N,lda", DECODE_KN)
@pytest.mark.parametrize("mode,n_stored", [
    ("M8", 1), ("M8", 2), ("M16", 1), ("M16", 3), ("M23", 3), ("M36", 5),
    ("M52", 7), ("M52", 3), (CUSTOM, 4), (CUSTOM, 2)])
def test_prelimbed_rows_are_batch_invariant(cuda, custom_format, mode,
                                            n_stored, K, N, lda):
    """The pre-limbed kernel's rows at M <= 17 equal the same rows at
    M = 70 bit for bit, with stacks below and above the format's limbs."""
    a, w = _rows_of(cuda, 70, K, lda, seed=96), _randn(cuda, K, N, seed=97)
    _underflow_row(a, w)
    limbs = mp_matmul.mp_decompose(w, n_stored)
    full = mp_matmul.mp_prelimbed_matmul(a, limbs, mode)
    for M in BATCH_MS:
        for rows in (slice(0, M), slice(70 - M, 70)):
            _assert_rows_bitwise(
                mp_matmul.mp_prelimbed_matmul(a[rows], limbs, mode), full,
                rows, (M, rows))


# (n_out, gate, biases, residual) of the projection's epilogues
PROJ_EPILOGUES = [(1, "none", True, True), (2, "none", False, False),
                  (3, "none", True, False), (3, "none", False, False),
                  (2, "swiglu", True, True), (2, "swiglu", False, False)]


@pytest.mark.parametrize("K,N,lda", DECODE_KN)
@pytest.mark.parametrize("n_out,gate,bias,res", PROJ_EPILOGUES)
@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M36", "M52", CUSTOM])
def test_fused_proj_rows_are_batch_invariant(cuda, custom_format, mode,
                                             n_out, gate, bias, res, K, N,
                                             lda):
    """The fused projection's rows at M <= 17 (the decode tile up to 16)
    equal the same rows of one launch at M = 70 (the prefill tile) bit for
    bit, epilogue included."""
    a = _rows_of(cuda, 70, K, lda, seed=100)
    ws = [_randn(cuda, K, N, seed=101 + t) for t in range(n_out)]
    _underflow_row(a, ws[0])
    for w in ws[1:]:
        w[:, 0] *= 1e-30
    bs = [_randn(cuda, N, seed=110 + t) for t in range(n_out)] if bias \
        else None
    r70 = _randn(cuda, 70, N, seed=120) if res else None

    def proj(rows):
        return mp_matmul.mp_fused_proj(
            a[rows], ws, mode, gate=gate, biases=bs,
            residual=None if r70 is None else r70[rows])

    full = proj(slice(0, 70))
    for M in BATCH_MS:
        for rows in (slice(0, M), slice(70 - M, 70)):
            want = full[rows] if gate == "swiglu" else full[:, rows]
            out = proj(rows)
            torch.cuda.synchronize()
            assert torch.equal(out.view(torch.int32),
                               want.view(torch.int32)), (M, rows)


@pytest.mark.parametrize("M", [8, 70])
@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M36", "M52", CUSTOM])
def test_fused_proj_outputs_are_the_fused_matmul(cuda, custom_format, mode,
                                                 M):
    """Without an epilogue, output t of the projection is bit for bit the
    fused matmul of A with weight t: each weight's chains are the fused
    matmul's, at decode (M = 8) and prefill (M = 70) tiles alike."""
    a = _randn(cuda, M, 200, seed=130)
    ws = [_randn(cuda, 200, 88, seed=131 + t) for t in range(3)]
    _underflow_row(a, ws[0])
    for n_out in (1, 2, 3):
        out = mp_matmul.mp_fused_proj(a, ws[:n_out], mode)
        for t in range(n_out):
            mm = mp_matmul.mp_fused_matmul(a, ws[t], mode)
            torch.cuda.synchronize()
            assert torch.equal(out[t].view(torch.int32),
                               mm.view(torch.int32)), (n_out, t)


@pytest.mark.parametrize("qk,pv,hkv,lengths", [
    ("M16", "M8", 12, (64, 0, 100, 288)),
    ("M23", "M16", 6, (17, 16, 1, 45)),
])
def test_paged_kernel_matches_plain(cuda, qk, pv, hkv, lengths):
    B, H, Dh, bs, n_blocks = len(lengths), 12, 64, 16, 80
    q = _randn(cuda, B, H, Dh, seed=63)
    kp = _randn(cuda, n_blocks, bs, hkv, Dh, seed=64)
    vp = _randn(cuda, n_blocks, bs, hkv, Dh, seed=65)
    W = max(-(-n // bs) for n in lengths) + 1      # one trash column
    table = torch.zeros((B, W), dtype=torch.int32)
    free = torch.randperm(n_blocks - 1,
                          generator=torch.Generator().manual_seed(0)) + 1
    used = 0
    for b, n in enumerate(lengths):
        k = -(-n // bs)
        table[b, :k] = free[used:used + k]
        used += k
    table = table.to(cuda)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = mp_attention.mp_paged_attention.launches
    out = mp_attention.mp_paged_attention(q, kp, vp, table, ln, qk, pv)
    assert mp_attention.mp_paged_attention.launches == before + 1
    ref = mp_attention.paged_attention_plain(q, kp, vp, table, ln,
                                             resolve(qk), resolve(pv),
                                             scale=0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not out[b].any()


def test_smoke_scheduler_on_the_card_batched_equals_solo(cuda):
    """The continuous scheduler on the card: streams decoded four to a
    micro-batch equal their solo runs bit for bit, and the decode path
    launches the pre-limbed and paged kernels only."""
    from repro_torch.serve.scheduler import ContinuousScheduler, \
        ScheduledRequest

    cfg = paper_mpfp.SMOKE
    eng = ServeEngine(cfg, T.init_params(cfg, seed=0), max_batch=4,
                      max_seq=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=n) for n in (5, 3, 9, 12)]

    def run(ps):
        sched = ContinuousScheduler(eng, n_blocks=32, block_size=8)
        done = sched.run([ScheduledRequest(rid=i, prompt=p, max_new=6)
                          for i, p in enumerate(ps)])
        return {r.rid: r.out for r in done}

    solo = [run([p])[0] for p in prompts]
    kernels.reset_launch_counts()
    got = run(prompts)
    counts = kernels.launch_counts()
    assert [got[i] for i in range(4)] == solo
    assert counts["mp_paged_attention"] > 0
    assert counts["mp_prelimbed_matmul"] > 0
    assert sum(kernels.plain_call_counts().values()) == 0


def test_rms_norm_row_is_batch_invariant(cuda):
    """A row's norm has the same bits whatever the number of rows beside
    it (the decode micro-batch width 1, 2, 4 or 8)."""
    from repro_torch.models.layers import rms_norm

    x = _randn(cuda, 8, 1, 768, seed=70)
    w = _randn(cuda, 768, seed=71)
    full = rms_norm(x, w)
    for b in (1, 2, 4):
        assert torch.equal(rms_norm(x[:b], w), full[:b]), b


# =========================================================================
# the mixed-lane kernels (slice 3)
# =========================================================================
MIXED_ROWS = ["M8", "M16", "M23", "M36", CUSTOM, "M8", "M16", "M23"]


def _lane_vectors(cuda, fmts):
    return (torch.tensor([f.n_limbs for f in fmts], dtype=torch.int32,
                         device=cuda),
            torch.tensor([f.max_order for f in fmts], dtype=torch.int32,
                         device=cuda))


def _envelope(fmts):
    from repro_torch.core.lanes import envelope_format

    return envelope_format(max(f.n_limbs for f in fmts),
                           max(f.max_order for f in fmts))


@pytest.mark.parametrize("M,K,N,n_stored", [
    (8, 768, 768, 5), (13, 300, 77, 4), (8, 200, 90, 2), (1, 768, 768, 5),
    (16, 300, 77, 4), (17, 200, 90, 2)])
def test_mixed_prelimbed_rows_are_the_homogeneous_kernel(
        cuda, custom_format, M, K, N, n_stored):
    """Each row of the mixed kernel is bit for bit the pre-limbed kernel's
    row at its own format (zero signs included; rows past the table's end
    at PAD_LANE), and the whole output is held at the f32 floor against
    the plain version."""
    fmts = [resolve(m) for m in (MIXED_ROWS * 3)[:M]]
    env = _envelope(fmts)
    a, w = _randn(cuda, M, K, seed=80), _randn(cuda, K, N, seed=81) * 0.05
    a[0, :3] = torch.tensor([0.0, -0.0, 1e-30], device=cuda)
    limbs = mp_matmul.mp_decompose(w, n_stored)
    ln, lo = _lane_vectors(cuda, fmts)
    before = mp_matmul.mp_mixed_prelimbed_matmul.launches
    out = mp_matmul.mp_mixed_prelimbed_matmul(a, limbs, env, ln, lo)
    assert mp_matmul.mp_mixed_prelimbed_matmul.launches == before + 1
    _assert_mm_close(out, mp_matmul.mixed_prelimbed_matmul_plain(
        a, limbs, env, ln, lo), K)
    for f in set(fmts):
        rows = [i for i, x in enumerate(fmts) if x == f]
        homo = mp_matmul.mp_prelimbed_matmul(a[rows], limbs, f)
        torch.cuda.synchronize()
        assert torch.equal(out[rows].view(torch.int32),
                           homo.view(torch.int32)), f.name


# lanes of the 70 rows, cycled: envelopes (5, 4) (M36's instantiation),
# (4, 3) (the generic one) and (3, 2) (the mixed-traffic tick's)
LANE_CYCLES = {"builtin": MIXED_ROWS, "generic": ["M8", CUSTOM, "M16", "M8"],
               "tick": ["M8", "M16", "M23", "M8"]}


@pytest.mark.parametrize("K,N,lda", DECODE_KN)
@pytest.mark.parametrize("cycle", sorted(LANE_CYCLES))
@pytest.mark.parametrize("n_stored", [2, 7])
def test_mixed_prelimbed_rows_are_batch_invariant(cuda, custom_format, cycle,
                                                  n_stored, K, N, lda):
    """The mixed kernel's rows at M <= 17 (the decode tile up to 16) equal
    the same rows of one launch at M = 70 (the prefill tile) bit for bit, at
    the same envelope, with stacks below and above it."""
    fmts = [resolve(m) for m in (LANE_CYCLES[cycle] * 70)[:70]]
    env = _envelope(fmts)
    a, w = _rows_of(cuda, 70, K, lda, seed=140), _randn(cuda, K, N, seed=141)
    _underflow_row(a, w)
    limbs = mp_matmul.mp_decompose(w, n_stored)
    ln, lo = _lane_vectors(cuda, fmts)
    full = mp_matmul.mp_mixed_prelimbed_matmul(a, limbs, env, ln, lo)
    for M in BATCH_MS:
        for rows in (slice(0, M), slice(70 - M, 70)):
            _assert_rows_bitwise(
                mp_matmul.mp_mixed_prelimbed_matmul(a[rows], limbs, env,
                                                    ln[rows], lo[rows]),
                full, rows, (M, rows))


@pytest.mark.parametrize("hkv,lengths", [(12, (64, 0, 100, 288, 5)),
                                         (6, (17, 16, 1, 45, 0))])
def test_mixed_paged_slots_are_the_homogeneous_kernel(cuda, custom_format,
                                                      hkv, lengths):
    """Each slot of the mixed paged kernel is bit for bit the paged
    kernel's at its own formats; the whole output is held at 2e-5 against
    the plain version; a length-0 slot writes exact zeros."""
    slots = [("M16", "M8"), ("M8", CUSTOM), ("M23", "M16"), (CUSTOM, "M23"),
             ("M36", "M8")]
    B, H, Dh, bs, n_blocks = len(lengths), 12, 64, 16, 80
    q = _randn(cuda, B, H, Dh, seed=82)
    kp = _randn(cuda, n_blocks, bs, hkv, Dh, seed=83)
    vp = _randn(cuda, n_blocks, bs, hkv, Dh, seed=84)
    W = max(-(-n // bs) for n in lengths) + 1
    table = torch.zeros((B, W), dtype=torch.int32)
    free = torch.randperm(n_blocks - 1,
                          generator=torch.Generator().manual_seed(1)) + 1
    used = 0
    for b, n in enumerate(lengths):
        k = -(-n // bs)
        table[b, :k] = free[used:used + k]
        used += k
    table = table.to(cuda)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    fq = [resolve(a) for a, _ in slots]
    fp = [resolve(b) for _, b in slots]
    eq, ep = _envelope(fq), _envelope(fp)
    lanes = (*_lane_vectors(cuda, fq), *_lane_vectors(cuda, fp))
    before = mp_attention.mp_mixed_paged_attention.launches
    out = mp_attention.mp_mixed_paged_attention(q, kp, vp, table, ln, eq,
                                                ep, *lanes)
    assert mp_attention.mp_mixed_paged_attention.launches == before + 1
    ref = mp_attention.mixed_paged_attention_plain(
        q, kp, vp, table, ln, eq, ep, *lanes, scale=0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    for b, n in enumerate(lengths):
        homo = mp_attention.mp_paged_attention(q, kp, vp, table, ln, fq[b],
                                               fp[b])
        torch.cuda.synchronize()
        assert torch.equal(out[b].view(torch.int32),
                           homo[b].view(torch.int32)), b
        if n == 0:
            assert not out[b].any()


# =========================================================================
# the paged kernels' chunked walk (chunks of PAGED_CHUNK_POS positions)
# =========================================================================
EDGE = mp_attention.PAGED_CHUNK_POS
# 8 slots each: lengths at the chunk's edges; length-0 slots; the largest
# logit in the first column, in the last (a one-position column at a chunk
# edge) and rising in every column (m_j moves inside a chunk); GQA
PAGED_LAYOUTS = {
    "chunk-edges": dict(lengths=(EDGE - 1, EDGE, EDGE + 1, 2 * EDGE - 1,
                                 2 * EDGE, 2 * EDGE + 1, 1, 16), hkv=12),
    "length-0": dict(lengths=(0, 37, 0, 300, 16, 0, 1, 0), hkv=12),
    "max-first-last-rising": dict(
        lengths=(200, 200, 200, 2 * EDGE + 1, 200, 200, 200, 2 * EDGE + 1),
        hkv=12,
        plant=[(0, 5, 8.0), (1, 197, 8.0), (3, 2 * EDGE, 8.0), (4, 2, 8.0),
               (5, 199, 8.0), (7, 2 * EDGE, 8.0)]
        + [(b, 16 * j + 7, 2.0 + 0.5 * j) for b in (2, 6)
           for j in range(13)]),
    "gqa": dict(lengths=(17, EDGE, EDGE + 1, 250, 0, 3, 2 * EDGE, 100),
                hkv=6),
    "w-padding": dict(lengths=(5, 16, 17, 70, 1, 64, 33, 80), hkv=12,
                      width=64),
}
PAGED_MIXED_SLOTS = [("M16", "M8"), ("M8", "M8"), ("M23", "M16"),
                     (CUSTOM, "M23"), ("M36", "M8"), ("M8", CUSTOM),
                     ("M16", "M16"), ("M23", "M23")]


def _paged_layout(cuda, layout, seed):
    """An 8-slot paged launch's inputs at bs 16, Dh 64, H 12: a table of
    distinct live blocks (trash block 0 after them) of ``width`` columns
    (default the power of two at least the longest slot's); each planted
    (slot, position, gain) gives the first query head of every kv head the
    logit ``gain`` there."""
    lengths, hkv = layout["lengths"], layout["hkv"]
    B, H, Dh, bs = len(lengths), 12, 64, 16
    cols = [-(-n // bs) for n in lengths]
    W = layout.get("width") or 1 << (max(max(cols), 1) - 1).bit_length()
    n_blocks = sum(cols) + 9
    q = _randn(cuda, B, H, Dh, seed=seed)
    kp = _randn(cuda, n_blocks, bs, hkv, Dh, seed=seed + 1)
    vp = _randn(cuda, n_blocks, bs, hkv, Dh, seed=seed + 2)
    free = (torch.randperm(n_blocks - 1,
                           generator=torch.Generator().manual_seed(seed))
            + 1).tolist()
    table = torch.zeros((B, W), dtype=torch.int32)
    for b, c in enumerate(cols):
        table[b, :c] = torch.tensor([free.pop() for _ in range(c)])
    for b, pos, gain in layout.get("plant", ()):
        for g in range(hkv):
            qr = q[b, g * (H // hkv)]
            kp[int(table[b, pos // bs]), pos % bs, g] = \
                gain * qr / (qr.dot(qr) * Dh ** -0.5)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return q, kp, vp, table.to(cuda), ln


def _assert_slots_batch_invariant(launch, out, table, lengths):
    """Slots launched 1, 2, 4 at a time (each group's table cut to its own
    power-of-two width) are bitwise their rows of the 8-slot launch."""
    for nb in (1, 2, 4):
        for b0 in range(0, len(lengths), nb):
            group = slice(b0, b0 + nb)
            cols = max(max(-(-n // 16) for n in lengths[group]), 1)
            w = 1 << (cols - 1).bit_length()
            part = launch(group, table[group, :w])
            torch.cuda.synchronize()
            assert torch.equal(part.view(torch.int32),
                               out[group].view(torch.int32)), (nb, b0)


def test_paged_chunk_is_128_positions(cuda):
    """The chunk the library plans at the decode shape, and under the
    mixed tick's (3, 3) envelope: PAGED_CHUNK_POS // bs columns."""
    assert mp_attention.paged_chunk_cols(64, 16, 1, 2, 1) == EDGE // 16
    assert mp_attention.paged_chunk_cols(64, 16, 1, 3, 3) == EDGE // 16
    assert mp_attention.paged_chunk_cols(64, 8) == EDGE // 8


@pytest.mark.parametrize("fmts", [("M16", "M8"), ("M23", "M16")])
@pytest.mark.parametrize("layout", sorted(PAGED_LAYOUTS))
def test_paged_slots_are_batch_invariant(cuda, layout, fmts):
    """The paged kernel at 8 slots against its plain version at 2e-5, a
    length-0 slot exact zeros, and every slot bitwise the same slot in
    launches of 1, 2 and 4 slots with their own table widths."""
    fq, fp = (resolve(m) for m in fmts)
    q, kp, vp, table, ln = _paged_layout(cuda, PAGED_LAYOUTS[layout], 91)
    lengths = PAGED_LAYOUTS[layout]["lengths"]
    out = mp_attention.mp_paged_attention(q, kp, vp, table, ln, fq, fp)
    ref = mp_attention.paged_attention_plain(q, kp, vp, table, ln, fq, fp,
                                             scale=0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not out[b].any()
    _assert_slots_batch_invariant(
        lambda s, t: mp_attention.mp_paged_attention(q[s], kp, vp, t, ln[s],
                                                     fq, fp),
        out, table, lengths)


@pytest.mark.parametrize("layout", sorted(PAGED_LAYOUTS))
def test_mixed_paged_slots_are_homogeneous_and_batch_invariant(
        cuda, custom_format, layout):
    """The mixed paged kernel on the same layouts: each slot bitwise the
    paged kernel at its formats, bitwise itself in smaller launches, all
    slots against the plain version at 2e-5."""
    q, kp, vp, table, ln = _paged_layout(cuda, PAGED_LAYOUTS[layout], 92)
    lengths = PAGED_LAYOUTS[layout]["lengths"]
    fq = [resolve(a) for a, _ in PAGED_MIXED_SLOTS]
    fp = [resolve(b) for _, b in PAGED_MIXED_SLOTS]
    eq, ep = _envelope(fq), _envelope(fp)
    lanes = (*_lane_vectors(cuda, fq), *_lane_vectors(cuda, fp))
    out = mp_attention.mp_mixed_paged_attention(q, kp, vp, table, ln, eq,
                                                ep, *lanes)
    ref = mp_attention.mixed_paged_attention_plain(
        q, kp, vp, table, ln, eq, ep, *lanes, scale=0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    for b, n in enumerate(lengths):
        homo = mp_attention.mp_paged_attention(q, kp, vp, table, ln, fq[b],
                                               fp[b])
        torch.cuda.synchronize()
        assert torch.equal(out[b].view(torch.int32),
                           homo[b].view(torch.int32)), b
        if n == 0:
            assert not out[b].any()
    _assert_slots_batch_invariant(
        lambda s, t: mp_attention.mp_mixed_paged_attention(
            q[s], kp, vp, t, ln[s], eq, ep, *(x[s] for x in lanes)),
        out, table, lengths)


def test_smoke_scheduler_mixed_modes_on_the_card(cuda, custom_format):
    """Four modes decoding together on the card: one launch per tick, the
    mixed-lane kernels only on the mixed ticks, each stream equal to its
    solo run bit for bit."""
    from repro_torch.serve.scheduler import ContinuousScheduler, \
        ScheduledRequest

    cfg = paper_mpfp.SMOKE
    eng = ServeEngine(cfg, T.init_params(cfg, seed=0), max_batch=4,
                      max_seq=64)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=n) for n in (5, 3, 9, 12)]
    modes = ["M8", "M16", "M23", CUSTOM]

    def run(ids):
        sched = ContinuousScheduler(eng, n_blocks=32, block_size=8)
        done = sched.run([ScheduledRequest(rid=i, prompt=prompts[i],
                                           max_new=6, mode=modes[i])
                          for i in ids])
        return {r.rid: r.out for r in done}, sched

    solo = [run([i])[0][i] for i in range(4)]
    kernels.reset_launch_counts()
    got, sched = run(range(4))
    counts = kernels.launch_counts()
    assert [got[i] for i in range(4)] == solo
    assert sched.stats()["launches_per_tick"] == 1.0
    assert counts["mp_mixed_prelimbed_matmul"] > 0
    assert counts["mp_mixed_paged_attention"] > 0
    assert sum(kernels.plain_call_counts().values()) == 0


@pytest.mark.parametrize("mode,na,nb", [
    ("M8", 1, 1), ("M16", 2, 2), ("M23", 3, 3), ("M36", 5, 5), ("M52", 7, 7),
    (CUSTOM, 4, 4), ("M52", 3, 7), ("M23", 5, 2)])
def test_both_prelimbed_kernel_matches_plain_and_fused(cuda, custom_format,
                                                       mode, na, nb):
    """The DD path's kernel at the f32 floor against its plain version on
    stacks of any stored depth, and bitwise the fused kernel on the raw
    operands whenever both stacks hold every limb the format needs."""
    a, b = _randn(cuda, 70, 200, seed=80), _randn(cuda, 200, 90, seed=81)
    al, bl = mp_matmul.mp_decompose(a, na), mp_matmul.mp_decompose(b, nb)
    before = mp_matmul.mp_both_prelimbed_matmul.launches
    out = mp_matmul.mp_both_prelimbed_matmul(al, bl, mode)
    assert mp_matmul.mp_both_prelimbed_matmul.launches == before + 1
    _assert_mm_close(out, mp_matmul.both_prelimbed_matmul_plain(al, bl, mode),
                     200)
    if min(na, nb) >= resolve(mode).n_limbs:
        assert torch.equal(out.view(torch.int32),
                           mp_matmul.mp_fused_matmul(a, b, mode)
                           .view(torch.int32))


@pytest.mark.parametrize("mode", ["M36", "M52"])
def test_dd_matmul_on_the_card_beats_the_f32_floor(cuda, mode):
    """tests/test_kernels.py's DD bound on the card: M36/M52 on two-float
    operands below 8 * 2^-24 * sqrt(K) of the float64 golden, and the
    limbs of each pair bitwise the CPU's (subnormal hi words included)."""
    from repro_torch.core import limbs
    from repro_torch.core.mpmatmul import mp_matmul as mm

    rng = np.random.default_rng(82)
    a64, b64 = rng.standard_normal((96, 300)), rng.standard_normal((300, 77))
    a, b = limbs.dd_from_f64(a64), limbs.dd_from_f64(b64)
    before = mp_matmul.mp_both_prelimbed_matmul.launches
    out = mm(a, b, mode)
    assert mp_matmul.mp_both_prelimbed_matmul.launches == before + 1
    gold = a64 @ b64
    rel = np.linalg.norm(out.cpu().numpy() - gold) / np.linalg.norm(gold)
    assert rel < 8 * 2.0 ** -24 * math.sqrt(300), rel
    tiny = limbs.dd_from_f64(a64 * 2.0 ** -140)
    for d in (a, tiny):
        dev = limbs.decompose_dd(d, 7)
        cpu = limbs.decompose_dd(limbs.DD(d.hi.cpu(), d.lo.cpu()), 7)
        assert torch.equal(dev.cpu().view(torch.int16), cpu.view(torch.int16))


def test_auto_selection_on_the_card(cuda):
    """AUTO on the card: the analysis stays a device tensor, one host read
    per call, M8 on integers with an exact product, the CPU's selection on
    full-mantissa data."""
    from repro_torch.core import auto, limbs

    rng = np.random.default_rng(83)
    ai = torch.from_numpy(rng.integers(-50, 50, (64, 96)).astype(np.float32))
    bi = torch.from_numpy(rng.integers(-50, 50, (96, 40)).astype(np.float32))
    k = limbs.significant_limbs(ai.to(cuda))
    assert k.device.type == "cuda" and k.dtype == torch.int32
    kernels.reset_launch_counts()
    out = auto.mp_matmul_auto(ai.to(cuda), bi.to(cuda))
    assert auto.mp_matmul_auto.host_reads == 1
    assert kernels.launch_counts()["mp_fused_matmul"] == 1
    assert torch.equal(out.cpu(), (ai.double() @ bi.double()).float())
    assert auto.auto_report(ai.to(cuda), bi.to(cuda))["selected_format"] \
        == "M8"
    a, b = _randn(cuda, 64, 96, seed=84), _randn(cuda, 96, 40, seed=85)
    assert int(auto.select_mode_index(a, b)) == \
        int(auto.select_mode_index(a.cpu(), b.cpu()))


def test_smoke_scheduler_auto_beside_mixed_on_the_card(cuda):
    """Static-format and AUTO requests together on the card: two launches
    per tick (one mixed, one AUTO bucket), the AUTO stream equal to its
    solo run bit for bit."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.serve.scheduler import ContinuousScheduler, \
        ScheduledRequest

    cfg = paper_mpfp.SMOKE
    eng = ServeEngine(cfg, T.init_params(cfg, seed=0), max_batch=4,
                      max_seq=64)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab, size=n) for n in (5, 3, 9)]
    auto = PrecisionPolicy.auto()

    def req(i):
        return ScheduledRequest(rid=i, prompt=prompts[i], max_new=6,
                                mode=(None if i == 2 else ("M8", "M23")[i]),
                                policy=auto if i == 2 else None)

    sched = ContinuousScheduler(eng, n_blocks=32, block_size=8)
    got = {r.rid: r.out for r in sched.run([req(i) for i in range(3)])}
    solo = ContinuousScheduler(eng, n_blocks=32, block_size=8).run(
        [req(2)])[0].out
    assert got[2] == solo
    assert sched.stats()["launches_per_tick"] == 2.0
    assert sum(kernels.plain_call_counts().values()) == 0


# =========================================================================
# the tensor-core order: K in chunks of KC k, one MMA chain per product,
# the chains summed by f32 adds, in both tiles alike
# =========================================================================
# K off the 64-k chunk, and across the decode tile's ring stages (256 k)
CHUNK_KS = [63, 65, 130, 1000]
# lanes of a mixed batch at or below each format (cycled over the rows)
CHUNK_LANES = {"M8": ["M8"], "M16": ["M8", "M16"],
               "M23": ["M8", "M16", "M23"], "M52": ["M8", "M23", "M52"]}


def test_chunk_k_is_64(cuda):
    """The chunk every kernel sums over: each limb product is one chain of
    64 / 16 MMAs."""
    assert mp_matmul.chunk_k() == 64


@pytest.mark.parametrize("K", CHUNK_KS)
@pytest.mark.parametrize("kind", ["fused", "prelimbed", "mixed", "proj"])
@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M52"])
def test_rows_are_batch_invariant_off_the_chunk(cuda, mode, kind, K):
    """Rows at M <= 17 (the decode tile up to 16) equal the same rows of one
    launch at M = 70 (the prefill tile) bit for bit when K is not a
    multiple of the chunk: both tiles run the last chunk on zero-filled
    planes, in the same MMA chains and adds."""
    fmt = resolve(mode)
    a = _randn(cuda, 70, K, seed=150)
    w, w2 = _randn(cuda, K, 40, seed=151), _randn(cuda, K, 40, seed=152)
    _underflow_row(a, w)
    limbs = mp_matmul.mp_decompose(w, fmt.n_limbs)
    fmts = [resolve(m) for m in (CHUNK_LANES[mode] * 70)[:70]]
    ln, lo = _lane_vectors(cuda, fmts)

    def run(rows):
        x = a[rows]
        if kind == "fused":
            return mp_matmul.mp_fused_matmul(x, w, fmt)
        if kind == "prelimbed":
            return mp_matmul.mp_prelimbed_matmul(x, limbs, fmt)
        if kind == "mixed":
            return mp_matmul.mp_mixed_prelimbed_matmul(
                x, limbs, _envelope(fmts), ln[rows], lo[rows])
        return mp_matmul.mp_fused_proj(x, [w, w2], fmt).transpose(0, 1)

    full = run(slice(0, 70))
    for M in BATCH_MS:
        for rows in (slice(0, M), slice(70 - M, 70)):
            _assert_rows_bitwise(run(rows), full, rows, (M, rows))


@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M52"])
def test_underflowing_sum_is_plus_zero_from_both_tiles(cuda, mode):
    """Row 0 of A against column 0 of B: every product is negative and far
    below the smallest subnormal, so the exact sum rounds to -0.0.  Each
    order's accumulator starts at +0.0 and takes the chunk's sum by an f32
    add, +0.0 + -0.0 = +0.0, so both tiles return +0.0, bit for bit alike
    at M = 70 (the prefill tile) and M <= 16 (the decode tile)."""
    a = _randn(cuda, 70, 200, seed=153)
    b = _randn(cuda, 200, 24, seed=154)
    a[0] = a[0].abs() * 1e-30 + 1e-30
    b[:, 0] = -(b[:, 0].abs() * 1e-30 + 1e-30)
    full = mp_matmul.mp_fused_matmul(a, b, mode)
    torch.cuda.synchronize()
    assert full[0, 0].item() == 0.0 and not torch.signbit(full[0, 0])
    for M in (1, 8, 16):
        _assert_rows_bitwise(mp_matmul.mp_fused_matmul(a[:M], b, mode), full,
                             slice(0, M), M)


@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M36", "M52", CUSTOM])
def test_prelimbed_both_and_proj_are_the_fused_matmul_at_prefill_shapes(
        cuda, custom_format, mode):
    """At the model's prefill shape (2048 x 768 x 768, the prefill tile):
    the pre-limbed kernel on the weight's limb stack, the both-prelimbed
    kernel on both operands' stacks and each output of the projection
    without an epilogue are bit for bit the fused matmul."""
    fmt = resolve(mode)
    a = _randn(cuda, 2048, 768, seed=155)
    ws = [_randn(cuda, 768, 768, seed=156 + t) * 0.03 for t in range(2)]
    fused = [mp_matmul.mp_fused_matmul(a, w, fmt) for w in ws]
    wl = mp_matmul.mp_decompose(ws[0], fmt.n_limbs)
    pl = mp_matmul.mp_prelimbed_matmul(a, wl, fmt)
    both = mp_matmul.mp_both_prelimbed_matmul(
        mp_matmul.mp_decompose(a, fmt.n_limbs), wl, fmt)
    proj = mp_matmul.mp_fused_proj(a, ws, fmt)
    torch.cuda.synchronize()
    for out in (pl, both, proj[0]):
        assert torch.equal(out.view(torch.int32), fused[0].view(torch.int32))
    assert torch.equal(proj[1].view(torch.int32), fused[1].view(torch.int32))


@pytest.mark.parametrize("M,K,N,n_stored", [
    (70, 768, 768, 3), (300, 1000, 200, 5), (2048, 768, 256, 3)])
def test_mixed_lanes_are_the_homogeneous_rows_at_prefill_shapes(
        cuda, custom_format, M, K, N, n_stored):
    """Each row of the mixed kernel on the prefill tile (M > 16) is bit for
    bit the pre-limbed kernel's row at its own format: the MMAs run at the
    envelope and each row adds only its lane's terms."""
    fmts = [resolve(m) for m in (MIXED_ROWS * M)[:M]]
    a, w = _randn(cuda, M, K, seed=158), _randn(cuda, K, N, seed=159) * 0.05
    limbs = mp_matmul.mp_decompose(w, n_stored)
    ln, lo = _lane_vectors(cuda, fmts)
    out = mp_matmul.mp_mixed_prelimbed_matmul(a, limbs, _envelope(fmts), ln,
                                              lo)
    for f in set(fmts):
        rows = [i for i, x in enumerate(fmts) if x == f]
        homo = mp_matmul.mp_prelimbed_matmul(a[rows], limbs, f)
        torch.cuda.synchronize()
        assert torch.equal(out[rows].view(torch.int32),
                           homo.view(torch.int32)), f.name


@pytest.mark.parametrize("mode", ["M8", "M16", "M23"])
def test_subnormal_products_are_kept(cuda, mode):
    """ROADMAP Queue 3's case on the card: B's last column is 1e-40 (an f32
    and bf16 subnormal), A's row 0 is +-3.39e38 and A[1, 3] is inf.  The
    kernel keeps the subnormal limbs and products, as the plain version
    does (XLA on the CPU flushes them): that column is within the f32
    floor of the plain version, its subnormal sums are not flushed to
    zero, its inf and NaN fall where the plain version's do, and the decode
    tile's rows are the prefill tile's bit for bit."""
    a = _randn(cuda, 4, 16, seed=160)
    a[0] = 3.39e38 * torch.sign(a[0])
    a[1, 3] = float("inf")
    b = _randn(cuda, 16, 5, seed=161)
    b[:, 4] = 1e-40
    out = mp_matmul.mp_fused_matmul(a, b, mode)[:, 4]
    ref = mp_matmul.fused_matmul_plain(a, b, mode)[:, 4]
    big = mp_matmul.mp_fused_matmul(
        torch.cat([a, _randn(cuda, 66, 16, seed=162)]), b, mode)[:4, 4]
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(out), fin)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    sub = fin & (ref.abs() < torch.finfo(torch.float32).tiny)
    assert sub.any() and (out[sub] != 0).all()
    _assert_within(out[fin], ref[fin], _floor(ref[fin], 16))
    assert torch.equal(out.view(torch.int32), big.view(torch.int32))


# ---------------------------------------------------------------------------
# the training slice's shapes and layouts
# ---------------------------------------------------------------------------
def _bitwise(x, y):
    torch.cuda.synchronize()
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("M,K,N", [(130, 200, 300), (256, 768, 3072)])
@pytest.mark.parametrize("mode", ["M8", "M16", "M23"])
def test_transposed_operands_are_the_contiguous_launch(cuda, mode, M, K, N):
    """dgrad's g @ W^T (B a transposed view, unit row stride) and a 2-D
    wgrad's x^T @ g (A a transposed view): the wrapper copies them to
    row-major, and the launch on the views as they are (the kernel's
    strided copies) gives the same bits; both agree with the plain
    version."""
    lib, stream = build.load("mp_matmul"), \
        torch.cuda.current_stream().cuda_stream
    g, w = _randn(cuda, M, N, seed=170), _randn(cuda, K, N, seed=171)
    x = _randn(cuda, M, K, seed=172)
    for a, b, k in ((g, w.t(), N), (x.t(), g, M)):
        out = mp_matmul.mp_fused_matmul(a, b, mode)
        assert _bitwise(out, mp_matmul.launch_fused_matmul(lib, stream, a, b,
                                                           resolve(mode)))
        assert _bitwise(out, mp_matmul.mp_fused_matmul(
            a.contiguous(), b.contiguous(), mode))
        _assert_mm_close(out, mp_matmul.fused_matmul_plain(a, b, mode), k)


@pytest.mark.parametrize("mode", ["M8", "M16", "M23"])
def test_attention_backward_products_batch_entries_are_solo(cuda, mode):
    """The attention backward's both-batched products at M = 128 (P^T·dO,
    dO·V^T, dS·K, dS^T·Qs on (B, H, S, Dh) views of (B, S, H, Dh) tensors):
    each (b, h) entry bitwise the same product launched alone, and the
    batch within the floor of the plain version."""
    B, H, S, Dh = 2, 3, 128, 64
    bshd = lambda s: _randn(cuda, B, S, H, Dh, seed=s).permute(0, 2, 1, 3)
    gh, vh, kh, qh = bshd(173), bshd(174), bshd(175), bshd(176)
    p = torch.softmax(_randn(cuda, B, H, S, S, seed=177), dim=-1)
    for a, b in ((p.transpose(-1, -2), gh), (gh, vh.transpose(-1, -2)),
                 (p, kh), (p.transpose(-1, -2), qh)):
        before = mp_matmul.mp_fused_matmul.launches
        out = mp_matmul.mp_fused_matmul(a, b, mode)
        assert mp_matmul.mp_fused_matmul.launches == before + 1
        _assert_mm_close(out, mp_matmul.fused_matmul_plain(a, b, mode),
                         a.shape[-1])
        for i in range(B):
            for j in range(H):
                solo = mp_matmul.mp_fused_matmul(a[i, j], b[i, j], mode)
                assert _bitwise(out[i, j], solo), (i, j)


@pytest.mark.parametrize("n_out", [2, 3])
@pytest.mark.parametrize("mode", ["M16", "M23"])
def test_fused_proj_without_gate_at_training_rows(cuda, mode, n_out):
    """The projection under autograd: gate "none", 2 (gate/up) or 3 (QKV)
    outputs at M = 1024 rows; each output the fused matmul's bits."""
    a = _randn(cuda, 1024, 768, seed=178)
    ws = [_randn(cuda, 768, 512, seed=179 + t) * 0.03 for t in range(n_out)]
    out = mp_matmul.mp_fused_proj(a, ws, mode)
    _assert_mm_close(out, mp_matmul.fused_proj_plain(a, ws, mode), 768)
    for t, w in enumerate(ws):
        assert _bitwise(out[t], mp_matmul.mp_fused_matmul(a, w, mode))


def test_wgrad_product_on_the_card_keeps_f32_elsewhere(cuda):
    """The weight gradient's one plain product (bf16 operands, f32 output,
    exact products) agrees with the CPU's within the f32 floor, and leaves
    the process's f32 matmul precision as it was."""
    from repro_torch.kernels import ref

    a, g = _randn(cuda, 8, 128, 768, seed=182), _randn(cuda, 8, 128, 256,
                                                       seed=183)
    assert torch.get_float32_matmul_precision() == "highest"
    for mode in ("M8", "M16", "M23"):
        out = ref.mp_wgrad_ref(a, g, mode)
        want = ref.mp_wgrad_ref(a.cpu(), g.cpu(), mode)
        _assert_mm_close(out, want.to(cuda), 3 * 1024)
        assert torch.get_float32_matmul_precision() == "highest"


def test_embedding_backward_on_the_card_is_the_cpus_sum(cuda):
    """The embedding's backward at the training shape (1,024 tokens, one
    id 300 times, a 32,000-row table): bitwise the CPU's token-order sum,
    twice the same bits, and no read back to the host (CUDA's sync debug
    mode raises on one)."""
    from repro_torch.models.layers import sorted_row_sum

    g = torch.Generator().manual_seed(184)
    V, D = 32000, 768
    ids = torch.cat([torch.zeros(300, dtype=torch.long),
                     torch.randint(0, 50, (400,), generator=g),
                     torch.randint(0, V, (324,), generator=g)])
    ids = ids[torch.randperm(1024, generator=g)]
    rows = torch.randn(1024, D, generator=g)
    want = sorted_row_sum(ids, rows, V)
    ids_c, rows_c = ids.to(cuda), rows.to(cuda)
    sorted_row_sum(ids_c, rows_c, V)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sorted_row_sum(ids_c, rows_c, V)
        again = sorted_row_sum(ids_c, rows_c, V)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)


def test_smoke_training_step_on_the_card(cuda):
    """A SMOKE train_default step with remat on the card: the launch counts
    of the formula, no plain-version call, the loss and every gradient
    leaf within 5e-4 of the CPU's, and the same step twice bitwise."""
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_lib

    cfg = paper_mpfp.SMOKE
    tcfg = trainer_lib.TrainerConfig(total_steps=10, warmup=2)
    gpu = trainer_lib.Trainer(cfg, tcfg)
    cpu = trainer_lib.Trainer(cfg, tcfg, device="cpu")
    state = cpu.init_state()
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=33,
                                   global_batch=4)).batch(0)
    gstate = trainer_lib.TrainState(
        tree_lib.map_(lambda x: x.to(cuda), state.params),
        adamw.init(tree_lib.map_(lambda x: x.to(cuda), state.params),
                   tcfg.opt))
    loss_fn = trainer_lib.make_loss_fn(cfg, gpu.policy)
    kernels.reset_launch_counts()
    (lg, _), gg = trainer_lib.value_and_grad(loss_fn, gstate.params,
                                             gpu.to_device(batch))
    L = cfg.n_layers
    assert kernels.launch_counts() == {
        **dict.fromkeys(kernels.KERNELS, 0), "mp_fused_proj": 4 * L,
        "mp_flash_attention": 2 * L, "mp_fused_matmul": 16 * L + 2}
    assert not any(kernels.plain_call_counts().values())
    (lc, _), gc = trainer_lib.value_and_grad(loss_fn, state.params,
                                             cpu.to_device(batch))
    assert abs(lg.item() - lc.item()) <= 1e-5 * abs(lc.item())
    for a, b in zip(tree_lib.leaves(gg), tree_lib.leaves(gc)):
        assert (a.cpu() - b).abs().max() <= 5e-4 * b.abs().max()
    s1, m1 = gpu._step_fn(gstate, gpu.to_device(batch))
    s2, m2 = gpu._step_fn(gstate, gpu.to_device(batch))
    assert _bitwise(m1["loss"], m2["loss"])
    for a, b in zip(tree_lib.leaves(s1), tree_lib.leaves(s2)):
        assert torch.equal(a, b)
    assert torch.get_float32_matmul_precision() == "highest"


def _fleet_requests(vocab, n=8, seed=2):
    from repro_torch.serve.scheduler import ScheduledRequest

    rng = np.random.default_rng(seed)
    return [ScheduledRequest(
        rid=i, prompt=rng.integers(1, vocab, size=int(rng.integers(3, 20))),
        max_new=int(rng.integers(4, 9)),
        mode=("M8", "M16", "M23", "M36")[i % 4], arrival=i // 2)
        for i in range(n)]


def test_smoke_fleet_is_the_scheduler_on_the_card(cuda):
    """Four SMOKE cells on the card under each placement policy: every
    stream bitwise the scheduler's on the same engine, the pools whole
    afterwards, no error on any cell's health record, no plain call."""
    from repro_torch.serve.fleet import FleetRouter, make_fleet
    from repro_torch.serve.scheduler import ContinuousScheduler

    cfg = paper_mpfp.SMOKE
    eng = ServeEngine(cfg, T.init_params(cfg, seed=0), max_batch=4,
                      max_seq=64, device=cuda)
    want = {r.rid: r.out for r in ContinuousScheduler(
        eng, n_blocks=48, block_size=8).run(_fleet_requests(cfg.vocab))}
    for policy in ("round_robin", "least_kv", "mode_affinity"):
        cells = make_fleet(eng, 4, n_blocks=12, block_size=8)
        kernels.reset_launch_counts()
        router = FleetRouter(cells, policy=policy)
        got = {r.rid: r.out for r in router.run(_fleet_requests(cfg.vocab))}
        assert got == want, policy
        assert all(c.pool.n_free == 11 for c in cells)
        assert sum(h.errors for h in router.health.values()) == 0
        assert kernels.launch_counts()["mp_paged_attention"] > 0
        assert not any(kernels.plain_call_counts().values())


def test_smoke_chaos_is_deterministic_on_the_card(cuda):
    """One seeded chaos plan twice over the same trace on the card: the same
    injector trace and the same streams, no lost request or leaked block,
    the untouched streams equal to the no-fault run's."""
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.fleet import FleetRouter, make_fleet

    cfg = paper_mpfp.SMOKE
    eng = ServeEngine(cfg, T.init_params(cfg, seed=0), max_batch=4,
                      max_seq=64, device=cuda)

    def run(plan):
        cells = make_fleet(eng, 4, n_blocks=24, block_size=8)
        router = FleetRouter(cells, policy="least_kv", fault_plan=plan)
        done = router.run(_fleet_requests(cfg.vocab, n=16, seed=3))
        assert len(done) == 16 and all(len(r.out) == r.max_new
                                       for r in done)
        assert router.stats()["blocks_live"] == 0
        return router, {r.rid: r for r in done}

    _, base = run(None)
    a, got = run(FaultPlan.chaos(seed=1, n_cells=4, horizon=12))
    b, again = run(FaultPlan.chaos(seed=1, n_cells=4, horizon=12))
    assert a.injector.trace and a.injector.trace == b.injector.trace
    assert {k: r.out for k, r in got.items()} == \
        {k: r.out for k, r in again.items()}
    for rid, r in got.items():
        if not r.recovery_prefixes and not r.guard_trips:
            assert r.out == base[rid].out


def test_smoke_auto_training_on_the_card(cuda):
    """A SMOKE step under PrecisionPolicy.auto() on the card: the loss and
    every gradient leaf within 5e-4 of the CPU's, remat on == off bitwise,
    and the host reads of the formula (9 AUTO matmuls a layer and chunk
    pair count, twice with remat)."""
    import dataclasses

    from repro_torch import tree as tree_lib
    from repro_torch.core import auto as auto_lib
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import trainer as trainer_lib

    cfg = paper_mpfp.SMOKE
    policy = PrecisionPolicy.auto()
    cpu = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(),
                              policy=policy, device="cpu")
    params = cpu.init_state().params
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=33,
                                   global_batch=4)).batch(0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def grads(model_cfg, dev):
        ps = tree_lib.map_(lambda x: x.to(dev), params)
        return trainer_lib.value_and_grad(
            trainer_lib.make_loss_fn(model_cfg, policy), ps,
            {k: v.to(dev) for k, v in tb.items()})

    kernels.reset_launch_counts()
    (lg, _), gg = grads(cfg, cuda)
    pairs = (32 // cfg.attn_q_chunk) * (32 // cfg.attn_kv_chunk)
    assert auto_lib.mp_matmul_auto.host_reads == \
        2 * (7 + 2 * pairs) * cfg.n_layers
    assert not any(kernels.plain_call_counts().values())
    (ln, _), gn = grads(dataclasses.replace(cfg, remat=False), cuda)
    assert _bitwise(lg, ln)
    assert all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(gg),
                                                 tree_lib.leaves(gn)))
    (lc, _), gc = grads(cfg, "cpu")
    assert abs(lg.item() - lc.item()) <= 1e-5 * abs(lc.item())
    for a, b in zip(tree_lib.leaves(gg), tree_lib.leaves(gc)):
        assert (a.cpu() - b).abs().max() <= 5e-4 * b.abs().max()


def test_cross_pool_handoff_reads_nothing_back(cuda):
    """A handoff between two pools on the card: the blocks' contents move
    by a gather and a scatter on the device; under CUDA's sync debug mode
    nothing synchronizes the host (the block ids only go to the card)."""
    from repro_torch.serve.fleet import KVHandoff, deliver
    from repro_torch.serve.kv_cache import PagedKVPool
    from repro_torch.serve.scheduler import ScheduledRequest

    src, dst = (PagedKVPool(2, 16, 8, 4, 64, max_blocks_per_seq=8)
                for _ in range(2))
    req = ScheduledRequest(rid=0, prompt=np.arange(9), max_new=8)
    req.blocks = src.alloc(3)
    src.k[:, req.blocks] = _randn(cuda, 2, 3, 8, 4, 64)
    want = src.k[:, req.blocks].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert deliver(KVHandoff(req=req, src_pool=src, src_cell=0), dst)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(dst.k[:, req.blocks], want)
    assert src.n_live == 0 and dst.n_live == 3


def test_autotune_sweeps_bitwise(cuda, tmp_path, monkeypatch):
    """The autotuner on the card: the libraries' shared-memory formulas
    (``mp_tile_smem_bytes``, ``mp_decode_smem_bytes``,
    ``mp_flash_smem_bytes``) and tile choices equal the Python mirrors;
    every candidate of ragged decode, prefill, projection and flash keys is
    bitwise the default launch (``autotune`` raises otherwise); the
    winners persist, and dispatch launching with them gives the default
    launches' bits."""
    import ctypes

    from repro_torch.core import dispatch
    from repro_torch.kernels import autotune as at

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", str(tmp_path))
    at.clear_memory_cache()
    at.reset_stats()
    lib = build.load("mp_matmul")
    mp_matmul._set_argtypes(lib)
    hlib = build.load("mp_matmul_hopper")
    mp_matmul._set_hopper_argtypes(hlib)
    for mode in ("M8", "M16", "M23", "M36", "M52", "M16FULLT"):
        if mode == "M16FULLT":
            register_format(mode, mantissa_bits=16, n_limbs=2, max_order=2)
        fmt = resolve(mode)
        nl, mo = fmt.n_limbs, fmt.max_order
        for nout in (1, 2):
            assert hlib.mp_tma_tile_n(nl, mo, nout) == at.tma_tile_n(fmt,
                                                                     nout)
            assert hlib.mp_tma_smem_bytes(nl, mo, nout) == at.tma_smem(
                fmt, nout)
        for kr, dk, cpr in ((512, 256, 8), (128, 64, 2), (384, 128, 6)):
            for M in (1, 8, 16):
                for pl, nout in ((False, 1), (True, 1), (False, 2),
                                 (False, 3)):
                    assert hlib.mp_split_smem_bytes(
                        pl, nl, mo, M, kr, dk, cpr, nout) == \
                        at.split_smem(fmt, M, kr, dk, cpr, pl, nout)
        if mode == "M16FULLT":
            unregister_format(mode)
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    sm_smem = props.shared_memory_per_multiprocessor
    optin = props.shared_memory_per_block_optin
    dk = ctypes.c_int(0)
    kinds = (("fused", False, 1), ("prelimbed", True, 1), ("proj", False, 1),
             ("proj", False, 2), ("mixed", True, 1))
    for mode in ("M8", "M16", "M23", "M52"):
        fmt = resolve(mode)
        for slabs in (1, 4, 48, 96, 144, 192, 263, 264, 2000):
            for K in (64, 100, 448, 768, 3072):
                for M in (1, 8, 16):
                    for (kind, pl, nout), regs in zip(
                            kinds, (0, 64, 72, 96, 168)):
                        S = hlib.mp_split_plan(pl, slabs, K, fmt.n_limbs,
                                               fmt.max_order, M, nout, regs,
                                               sms, sm_smem, optin,
                                               ctypes.byref(dk))
                        assert (S, dk.value) == at.split_plan(
                            slabs, K, fmt, M, sms, sm_smem, optin, pl, nout,
                            regs)
                for S in range(1, 9):
                    assert hlib.mp_split_norm(K, S) == at.split_norm(K, S)
        for kr, cpr in ((128, 2), (512, 8), (1536, 24)):
            for pl, nout in ((False, 1), (True, 1), (False, 2), (False, 3)):
                assert hlib.mp_split_dk(pl, fmt.n_limbs, fmt.max_order, 8,
                                        kr, cpr, nout, optin) == \
                    at.split_dk(fmt, 8, kr, cpr, optin, pl, nout)
        # the plan of each split kernel on its own registers (ptxas's)
        for kind, pl, nout in kinds:
            regs = mp_matmul.split_regs(kind, fmt, nout)
            assert 0 < regs <= 255, (kind, mode)
            slabs = 48 * (3 if kind == "proj" and nout == 1 else 1)
            assert mp_matmul.decode_plan(
                8, 768, 768, fmt, kind=kind, n_out=3 if nout == 1 else 2,
                gate=nout == 2) == at.split_plan(
                    slabs, 768, fmt, 8, sms, sm_smem, optin, pl, nout, regs)
    for nl, mo in at.BUILTIN + ((2, 2), (4, 3)):
        resolved = next((f for f in ("M8", "M16", "M23", "M36", "M52")
                         if (resolve(f).n_limbs, resolve(f).max_order)
                         == (nl, mo)), None)
        for n_out in (1, 2, 3):
            if resolved:
                assert lib.mp_tile_e(nl, mo, n_out) == \
                    at.format_tile_e(resolved, n_out)
                assert lib.mp_tile_e_alt(nl, mo, n_out) == \
                    at.format_tile_e_alt(resolved, n_out)
            for e in (4, 8, 16, 32, 64):
                for pl, pla in ((0, 0), (1, 0), (1, 1)):
                    assert lib.mp_tile_smem_bytes(nl, n_out, e, pl, pla) == \
                        at.tile_smem(nl, n_out, e, bool(pl), bool(pla))
        assert lib.mp_decode_ring_k(nl, mo) == (
            at.decode_ring_k(resolved) if resolved else 128)
        for M in (1, 8, 16):
            for dk in (64, 128, 192, 256):
                for slots in (1, 3):
                    for nout in (1, 2):
                        for pl in (0, 1):
                            assert lib.mp_decode_smem_bytes(
                                pl, nl, M, dk, slots, nout) == \
                                at.dec_smem_bytes(bool(pl), nl, M, dk, slots,
                                                  nout)
    alib = build.load("mp_attention")
    alib.mp_flash_smem_bytes.argtypes = [ctypes.c_int64] * 6
    alib.mp_flash_smem_bytes.restype = ctypes.c_int64
    for Dh in (16, 40, 64, 80, 128, 192):
        for bq in (16, 32, 64):
            for q, p in (("M8", "M8"), ("M16", "M8"), ("M23", "M23"),
                         ("M36", "M16")):
                fq, fp = resolve(q), resolve(p)
                assert mp_attention.flash_smem_bytes(Dh, bq, fq, fp) == \
                    at.flash_smem(Dh, bq, fq, fp)
    keys = [(70, 96, 200, "M16", 1, "none"), (8, 700, 300, "M8", 2, "swiglu"),
            (40, 64, 96, "M23", 3, "none"), (5, 130, 64, "M52", 1, "none"),
            (2048, 768, 768, "M8", 1, "none"), (8, 3072, 768, "M8", 1, "none"),
            (8, 1000, 200, "M23", 1, "none")]
    for M, K, N, f, n_out, ep in keys:
        rec = {}
        got = at.autotune(M, K, N, f, n_out=n_out, epilogue=ep, iters=2,
                          record=rec)
        assert list(got) == rec["winner"]
        # the fused matmul's prefill tiles have no free parameter, nor the
        # projection's TMA tile (K and N multiples of 4)
        prefill_mm = M > 16 and (n_out == 1 and ep == "none"
                                 or K % 4 == 0 and N % 4 == 0)
        assert (len(rec["candidates"]) == 0) == prefill_mm
        assert rec["winner_ms"] <= rec["default_ms"]
        assert rec["default_won"] == (list(got) == [0, 0])
    rec = {}
    at.autotune_attention(6, 40, 40, 64, "M16", "M8", iters=2, record=rec)
    assert len(rec["candidates"]) == 2      # 64 rows exceed S = 40
    assert at.stats()["sweeps"] == len(keys) + 1
    table = dict(at.load_table())
    at.clear_memory_cache()
    assert at.load_table() == table
    # dispatch launches with the winners: the default launches' bits
    a, b = _randn(cuda, 70, 96), _randn(cuda, 96, 200, seed=1)
    x, ws = _randn(cuda, 8, 700), [_randn(cuda, 700, 300, seed=s)
                                   for s in (2, 3)]
    tuned = (dispatch.dispatch(a, b, "M16", backend="cuda"),
             dispatch.dispatch_fused(x, ws, "M8", gate="swiglu",
                                     backend="cuda"))
    assert at.stats()["hits"] >= 2
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", str(tmp_path / "none"))
    at.clear_memory_cache()
    plain = (dispatch.dispatch(a, b, "M16", backend="cuda"),
             dispatch.dispatch_fused(x, ws, "M8", gate="swiglu",
                                     backend="cuda"))
    assert all(torch.equal(t, p) for t, p in zip(tuned, plain))
    at.clear_memory_cache()


# ---------------------------------------------------------------------------
# the fused matmul's Hopper tiles (csrc/mp_matmul_hopper.cu)
# ---------------------------------------------------------------------------
def _routed(fn, *args, **kw):
    before = dict(fn.routes)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, next(k for k, v in fn.routes.items() if v != before[k])


@pytest.mark.parametrize("M,K,N", [(8, 3072, 768), (3, 200, 72),
                                   (16, 1000, 264), (70, 200, 72),
                                   (130, 1000, 264), (300, 768, 200)])
@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M52"])
def test_hopper_tiles_are_the_prelimbed_kernel(cuda, mode, M, K, N):
    """The TMA prefill tile (M > 16) and the cluster-split decode tile (M <=
    16) bitwise the pre-limbed kernel (the strided tiles of
    csrc/mp_matmul.cu) on planes cut from the same weight, over ragged
    shapes; the partials stack of each combines to the fused output."""
    from repro_torch.kernels import ref as ref_lib

    a, b = _randn(cuda, M, K, seed=180), _randn(cuda, K, N, seed=181)
    out, route = _routed(mp_matmul.mp_fused_matmul, a, b, mode)
    assert route == (mp_matmul.SPLIT if M <= 16 else mp_matmul.TMA)
    planes = mp_matmul.mp_decompose(b, resolve(mode).n_limbs)
    assert _bitwise(out, mp_matmul.mp_prelimbed_matmul(a, planes, mode))
    parts, proute = _routed(mp_matmul.mp_fused_matmul_partials, a, b, mode)
    # the partials' prefill keeps the strided tile at more than one limb
    assert proute == (route if M <= 16 or resolve(mode).n_limbs == 1
                      else mp_matmul.STRIDED)
    assert _bitwise(ref_lib.combine_partials(parts, resolve(mode)), out)
    _assert_mm_close(out, mp_matmul.fused_matmul_plain(a, b, mode), K)


@pytest.mark.parametrize("M,K,N,mode", [(8, 3072, 768, "M8"),
                                        (8, 768, 768, "M8"),
                                        (5, 1000, 200, "M23"),
                                        (8, 768, 2000, "M16"),
                                        (70, 768, 768, "M8"),
                                        (200, 448, 264, "M16"),
                                        (130, 200, 72, "M36")])
def test_every_launch_the_plan_allows_is_bitwise_the_default(cuda, M, K, N,
                                                             mode):
    """Every cluster size and stage depth of the decode tile the autotuner
    may choose (its candidates) gives the default launch's bits; the TMA
    tile has no parameter to choose, and refuses one."""
    from repro_torch.kernels import autotune as at

    a, b = _randn(cuda, M, K, seed=182), _randn(cuda, K, N, seed=183)
    ref = mp_matmul.mp_fused_matmul(a, b, mode)
    cands = at.candidate_blocks(M, K, N, mode)
    if M > 16:
        assert cands == []
        with pytest.raises(ValueError, match="takes no launch parameters"):
            mp_matmul.mp_fused_matmul(a, b, mode, tune=(0, 2))
        return
    assert {s for _, s in cands} >= {1, at.split_plan(-(-N // 16), K,
                                                      mode, M)[0]}
    for tune in cands:
        assert _bitwise(mp_matmul.mp_fused_matmul(a, b, mode, tune=tune),
                        ref), tune


@pytest.mark.parametrize("mode", ["M8", "M16"])
def test_batched_and_transposed_operands_route_and_keep_the_bits(cuda,
                                                                  mode):
    """A two-dim batch of row-major operands takes the TMA tile (4-d tensor
    maps), a stride-0 token broadcast and a transposed view read as it is
    the strided tile; each entry bitwise the same product alone, and the
    view bitwise its row-major copy."""
    a = _randn(cuda, 2, 3, 40, 64, seed=184)
    b = _randn(cuda, 2, 3, 64, 48, seed=185)
    out, route = _routed(mp_matmul.mp_fused_matmul, a, b, mode)
    assert route == mp_matmul.TMA
    for i in range(2):
        for j in range(3):
            assert _bitwise(out[i, j], mp_matmul.mp_fused_matmul(
                a[i, j].contiguous(), b[i, j].contiguous(), mode))
    tok = _randn(cuda, 40, 64, seed=186).expand(5, 40, 64)
    w = _randn(cuda, 5, 64, 48, seed=187)
    out, route = _routed(mp_matmul.mp_fused_matmul, tok, w, mode)
    assert route == mp_matmul.STRIDED
    assert _bitwise(out[2], mp_matmul.mp_fused_matmul(
        tok[2].contiguous(), w[2].contiguous(), mode))
    lib, stream = build.load("mp_matmul"), \
        torch.cuda.current_stream().cuda_stream
    g, wt = _randn(cuda, 130, 300, seed=188), _randn(cuda, 200, 300, seed=189)
    view = mp_matmul.launch_fused_matmul(lib, stream, g, wt.t(),
                                         resolve(mode))
    assert _bitwise(view, mp_matmul.mp_fused_matmul(g, wt.t().contiguous(),
                                                    mode))


@pytest.mark.parametrize("M", [8, 70])
def test_minus_zero_and_subnormal_products_on_the_hopper_tiles(cuda, M):
    """compare_kernels.py's two edge cases on this tree: a row whose
    products are all -0.0, and the subnormal products of
    test_subnormal_products_are_kept, through the Hopper tiles and the
    strided tile of csrc/mp_matmul.cu (the mma.sync chains) on the same
    operands: bitwise."""
    lib, stream = build.load("mp_matmul"), \
        torch.cuda.current_stream().cuda_stream
    neg = _randn(cuda, 70, 256, seed=190)
    neg[3] = -0.0
    pos = _randn(cuda, 256, 64, seed=191).abs() + 0.1
    sub = _randn(cuda, 70, 16, seed=192)
    sub[0] = 3.39e38 * torch.sign(sub[0])
    sub[1, 3] = float("inf")
    sub_b = _randn(cuda, 16, 8, seed=193)
    sub_b[:, 4] = 1e-40
    for a, b, mode in ((neg, pos, "M8"), (sub, sub_b, "M16"),
                       (sub, sub_b, "M23")):
        out = mp_matmul.mp_fused_matmul(a[:M], b, mode)
        big = mp_matmul.launch_fused_matmul(lib, stream, a, b, resolve(mode))
        assert _bitwise(out, big[:M])
    out = mp_matmul.mp_fused_matmul(neg[:M], pos, "M8")
    torch.cuda.synchronize()
    assert (out[3] == 0).all() and not torch.signbit(out[3]).any()


# ---------------------------------------------------------------------------
# the projection's TMA tile and the pre-limbed split tile
# (csrc/mp_matmul_hopper.cu)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N", [(70, 200, 72), (130, 768, 264),
                                   (300, 448, 200), (2048, 768, 768)])
@pytest.mark.parametrize("n_out,gate,bias,res", PROJ_EPILOGUES)
@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M52", CUSTOM])
def test_projection_tma_tile_is_the_strided_tile(cuda, custom_format, mode,
                                                 n_out, gate, bias, res, M,
                                                 K, N):
    """The projection's TMA prefill tile bitwise its strided tile (the
    mma.sync chains of csrc/mp_matmul.cu) on the same operands, every
    epilogue; without one, each output bitwise the fused matmul."""
    a = _randn(cuda, M, K, seed=200)
    ws = [_randn(cuda, K, N, seed=201 + t) for t in range(n_out)]
    _underflow_row(a, ws[0])
    bs = [_randn(cuda, N, seed=210 + t) for t in range(n_out)] if bias \
        else None
    r = _randn(cuda, M, N, seed=220) if res else None
    kw = dict(gate=gate, biases=bs, residual=r)
    out, route = _routed(mp_matmul.mp_fused_proj, a, ws, mode, **kw)
    assert route == mp_matmul.TMA
    strided = mp_matmul.launch_fused_proj(
        build.load("mp_matmul"), torch.cuda.current_stream().cuda_stream,
        a, ws, resolve(mode), **kw)
    assert _bitwise(out, strided)
    if gate == "none" and not bias and not res:
        for t in range(n_out):
            assert _bitwise(out[t], mp_matmul.mp_fused_matmul(a, ws[t],
                                                              mode)), t


def test_projection_routes_on_the_card(cuda):
    """Rows off 16 bytes (N = 70) and a misaligned base keep the strided
    tile, M <= 16 the split decode tile; each bitwise the TMA tile's
    rows."""
    a = _randn(cuda, 70, 200, seed=230)
    ws = [_randn(cuda, 200, 72, seed=231 + t) for t in range(3)]
    full, route = _routed(mp_matmul.mp_fused_proj, a, ws, "M16")
    assert route == mp_matmul.TMA
    dec, route = _routed(mp_matmul.mp_fused_proj, a[:8], ws, "M16")
    assert route == mp_matmul.SPLIT and _bitwise(dec, full[:, :8])
    off = torch.empty(70 * 200 + 1, device=a.device)[1:].view(70, 200)
    off.copy_(a)
    mis, route = _routed(mp_matmul.mp_fused_proj, off, ws, "M16")
    assert route == mp_matmul.STRIDED and _bitwise(mis, full)
    narrow = [w[:, :70].contiguous() for w in ws]
    out, route = _routed(mp_matmul.mp_fused_proj, a, narrow, "M16")
    assert route == mp_matmul.STRIDED and _bitwise(out, full[..., :70])
    with pytest.raises(ValueError, match="takes no launch parameters"):
        mp_matmul.mp_fused_proj(a, ws, "M16", tune=(0, 16))


@pytest.mark.parametrize("M,K,N,mode,n_stored", [
    (8, 3072, 768, "M8", 2), (8, 768, 768, "M8", 2), (8, 768, 3072, "M8", 2),
    (8, 768, 32000, "M16", 2), (8, 3072, 768, "M16", 3),
    (8, 3072, 768, "M23", 3), (5, 1000, 200, "M23", 3), (3, 200, 72, "M8", 1),
    (16, 448, 264, "M52", 7), (8, 300, 77, "M16", 2), (1, 768, 768, "M36", 5),
    (8, 768, 768, "M16", 1)])
def test_prelimbed_split_tile_is_the_fused_matmul(cuda, M, K, N, mode,
                                                  n_stored):
    """The pre-limbed split decode tile (its planes by TMA; N = 77, whose
    planes no map reads, the single-block tile): bitwise the fused matmul
    on the weight the planes came from (every limb stored), bitwise the
    same rows of an M = 70 launch (the mma.sync tile), and bitwise at
    every cluster size and stage the plan allows."""
    from repro_torch.kernels import autotune as at

    a70, w = _randn(cuda, 70, K, seed=240), _randn(cuda, K, N, seed=241)
    _underflow_row(a70, w)
    limbs = mp_matmul.mp_decompose(w, n_stored)
    a = a70[:M]
    out, route = _routed(mp_matmul.mp_prelimbed_matmul, a, limbs, mode)
    assert route == mp_matmul.SPLIT
    full, route = _routed(mp_matmul.mp_prelimbed_matmul, a70, limbs, mode)
    assert route == mp_matmul.MMA and _bitwise(out, full[:M])
    if n_stored >= resolve(mode).n_limbs:
        assert _bitwise(out, mp_matmul.mp_fused_matmul(a, w, mode))
    stream = torch.cuda.current_stream().cuda_stream
    nch = -(-K // at.KC)
    for S in sorted({at.split_norm(K, s) for s in (1, 2, 4, 8)}):
        cpr = -(-nch // S)
        kr = K if S == 1 else cpr * at.KC
        for dk in range(at.KC, min(at.decode_ring_k(mode),
                                   -(-kr // at.KC) * at.KC) + 1, at.KC):
            if S > 1 and at.split_smem(mode, M, kr, dk, cpr, True) > \
                    at.smem_limit():
                continue
            if S > 1 and N % 8:
                # no tensor map reads these planes: a cluster is refused
                with pytest.raises(RuntimeError, match="CUDA error"):
                    mp_matmul.launch_prelimbed_routed(
                        stream, a, limbs, resolve(mode), (dk, S))
                continue
            got, _ = mp_matmul.launch_prelimbed_routed(
                stream, a, limbs, resolve(mode), (dk, S))
            assert _bitwise(got, out), (S, dk)


@pytest.mark.parametrize("M", [4, 8])
def test_minus_zero_and_subnormal_products_on_the_prelimbed_split(cuda, M):
    """compare_kernels.py's edge cases through the pre-limbed split tile
    (planes by TMA) and the projection's TMA tile: bitwise the mma.sync
    tiles of csrc/mp_matmul.cu on the same operands (the pre-limbed
    kernel at 70 rows, the strided projection tile), and a row of -0.0
    products stays +0.0."""
    lib, stream = build.load("mp_matmul"), \
        torch.cuda.current_stream().cuda_stream
    neg = _randn(cuda, 70, 256, seed=250)
    neg[3] = -0.0
    pos = _randn(cuda, 256, 64, seed=251).abs() + 0.1
    sub = _randn(cuda, 70, 16, seed=252)
    sub[0] = 3.39e38 * torch.sign(sub[0])
    sub[1, 3] = float("inf")
    sub_b = _randn(cuda, 16, 8, seed=253)
    sub_b[:, 4] = 1e-40
    for a, b, mode, n_stored in ((neg, pos, "M8", 1), (sub, sub_b, "M16", 2),
                                 (sub, sub_b, "M23", 3)):
        limbs = mp_matmul.mp_decompose(b, n_stored)
        out, route = _routed(mp_matmul.mp_prelimbed_matmul, a[:M], limbs,
                             mode)
        assert route == mp_matmul.SPLIT
        big = mp_matmul.launch_prelimbed_matmul(lib, stream, a, limbs,
                                                resolve(mode))
        assert _bitwise(out, big[:M])
        ws = [b, b * 0.5]
        proj, route = _routed(mp_matmul.mp_fused_proj, a, ws, mode)
        assert route == mp_matmul.TMA
        assert _bitwise(proj, mp_matmul.launch_fused_proj(
            lib, stream, a, ws, resolve(mode)))
        gated = mp_matmul.mp_fused_proj(a, ws, mode, gate="swiglu")
        assert _bitwise(gated, mp_matmul.launch_fused_proj(
            lib, stream, a, ws, resolve(mode), gate="swiglu"))
    out = mp_matmul.mp_prelimbed_matmul(neg[:M], mp_matmul.mp_decompose(
        pos, 1), "M8")
    torch.cuda.synchronize()
    assert (out[3] == 0).all() and not torch.signbit(out[3]).any()


# ---------------------------------------------------------------------------
# the projection's and the mixed-lane matmul's split decode tiles
# (csrc/mp_matmul_hopper.cu)
# ---------------------------------------------------------------------------
def _split_tunes(mode, M, K, pl=False, nout=1):
    """Every (dk, S) of a split decode tile within the card's shared
    memory: S in 1, 2, 4, 8 as the tile runs them, dk in steps of KC up to
    the ring's most and the rank's K range (S = 1: the single-block
    tile)."""
    from repro_torch.kernels import autotune as at

    out, nch = [], -(-K // at.KC)
    for S in sorted({at.split_norm(K, s) for s in (1, 2, 4, 8)}):
        cpr = -(-nch // S)
        kr = K if S == 1 else cpr * at.KC
        for dk in range(at.KC, min(at.decode_ring_k(mode),
                                   -(-kr // at.KC) * at.KC) + 1, at.KC):
            need = (at.dec_smem_bytes(pl, resolve(mode).n_limbs, M, dk,
                                      min(at.DEC_SLOTS, -(-K // dk)), nout)
                    if S == 1 else at.split_smem(mode, M, kr, dk, cpr, pl,
                                                 nout))
            if need <= at.smem_limit():
                out.append((dk, S))
    return out


@pytest.mark.parametrize("M,K,N", [(8, 768, 768), (4, 200, 72),
                                   (16, 1000, 264)])
@pytest.mark.parametrize("n_out,gate,bias,res", PROJ_EPILOGUES)
@pytest.mark.parametrize("mode", ["M8", "M16", "M23", CUSTOM])
def test_projection_split_tile_is_the_single_block_tile(
        cuda, custom_format, mode, n_out, gate, bias, res, M, K, N):
    """The projection's split decode tile: the plan's launch bitwise the
    single-block tile (S = 1, fused_proj_decode_kernel as it was) and
    every (dk, S) the card holds, every epilogue (bias, then silu(g) * u,
    then the residual, after the cluster's join); the rows bitwise an M =
    70 launch's (the TMA tile); without an epilogue each weight bitwise
    the fused matmul."""
    a70 = _randn(cuda, 70, K, seed=260)
    ws = [_randn(cuda, K, N, seed=261 + t) for t in range(n_out)]
    _underflow_row(a70, ws[0])
    bs = [_randn(cuda, N, seed=270 + t) for t in range(n_out)] if bias \
        else None
    r70 = _randn(cuda, 70, N, seed=280) if res else None
    a, r = a70[:M], (r70[:M] if res else None)
    out, route = _routed(mp_matmul.mp_fused_proj, a, ws, mode, gate=gate,
                         biases=bs, residual=r)
    assert route == mp_matmul.SPLIT
    full = mp_matmul.mp_fused_proj(a70, ws, mode, gate=gate, biases=bs,
                                   residual=r70)
    assert _bitwise(out, full[..., :M, :])
    nout = 2 if gate != "none" else 1
    for tune in _split_tunes(mode, M, K, nout=nout):
        got = mp_matmul.mp_fused_proj(a, ws, mode, gate=gate, biases=bs,
                                      residual=r, tune=tune)
        assert _bitwise(got, out), tune
    if gate == "none" and not bias and not res:
        for t in range(n_out):
            assert _bitwise(out[t], mp_matmul.mp_fused_matmul(a, ws[t],
                                                              mode)), t


@pytest.mark.parametrize("M,K,N,n_stored", [
    (8, 768, 768, 3), (8, 3072, 768, 3), (4, 768, 3072, 3), (16, 448, 88, 2),
    (8, 300, 77, 3), (1, 768, 768, 5)])
@pytest.mark.parametrize("cycle", sorted(LANE_CYCLES))
def test_mixed_split_tile_rows_are_the_homogeneous_rows(
        cuda, custom_format, cycle, M, K, N, n_stored):
    """The mixed-lane split decode tile (the envelope's planes by TMA; N =
    77, whose planes no map reads, the single-block tile): each row
    bitwise the pre-limbed row at its lane's format, the rows bitwise an M
    = 70 launch's (the mma.sync tile), and every (dk, S) the card holds
    bitwise the plan's launch (a cluster on planes no map reads is
    refused)."""
    fmts = [resolve(m) for m in (LANE_CYCLES[cycle] * 70)[:70]]
    env = _envelope(fmts)
    a70, w = _randn(cuda, 70, K, seed=290), _randn(cuda, K, N, seed=291)
    _underflow_row(a70, w)
    limbs = mp_matmul.mp_decompose(w, n_stored)
    ln, lo = _lane_vectors(cuda, fmts)
    full, route = _routed(mp_matmul.mp_mixed_prelimbed_matmul, a70, limbs,
                          env, ln, lo)
    assert route == mp_matmul.MMA
    a, lnm, lom = a70[:M], ln[:M].contiguous(), lo[:M].contiguous()
    out, route = _routed(mp_matmul.mp_mixed_prelimbed_matmul, a, limbs, env,
                         lnm, lom)
    assert route == mp_matmul.SPLIT and _bitwise(out, full[:M])
    for f in set(fmts[:M]):
        rows = [i for i, x in enumerate(fmts[:M]) if x == f]
        homo = mp_matmul.mp_prelimbed_matmul(a[rows], limbs, f)
        assert _bitwise(out[rows], homo), f.name
    stream = torch.cuda.current_stream().cuda_stream
    for dk, S in _split_tunes(env, M, K, pl=True):
        if S > 1 and N % 8:
            with pytest.raises(RuntimeError, match="CUDA error"):
                mp_matmul.launch_mixed_routed(stream, a, limbs, env, lnm,
                                              lom, (dk, S))
            continue
        got, _ = mp_matmul.launch_mixed_routed(stream, a, limbs, env, lnm,
                                               lom, (dk, S))
        assert _bitwise(got, out), (dk, S)


@pytest.mark.parametrize("M", [4, 8])
def test_minus_zero_and_subnormal_products_on_the_new_splits(
        cuda, custom_format, M):
    """compare_kernels.py's edge cases through the projection's and the
    mixed-lane matmul's split tiles: bitwise their single-block tiles (S =
    1) and the rows of a 70-row launch, the mixed rows bitwise the
    pre-limbed rows at their lanes; a row of -0.0 products stays +0.0."""
    neg = _randn(cuda, 70, 256, seed=250)
    neg[3] = -0.0
    pos = _randn(cuda, 256, 64, seed=251).abs() + 0.1
    sub = _randn(cuda, 70, 16, seed=252)
    sub[0] = 3.39e38 * torch.sign(sub[0])
    sub[1, 3] = float("inf")
    sub_b = _randn(cuda, 16, 8, seed=253)
    sub_b[:, 4] = 1e-40
    fmts = [resolve(m) for m in (["M8", "M16", "M23", CUSTOM] * 18)[:70]]
    env = _envelope(fmts)
    ln, lo = _lane_vectors(cuda, fmts)
    for a, b, mode in ((neg, pos, "M8"), (sub, sub_b, "M16"),
                       (sub, sub_b, "M23")):
        ws = [b, b * 0.5]
        for gate in ("none", "swiglu"):
            out, route = _routed(mp_matmul.mp_fused_proj, a[:M], ws, mode,
                                 gate=gate)
            assert route == mp_matmul.SPLIT
            one = mp_matmul.mp_fused_proj(a[:M], ws, mode, gate=gate,
                                          tune=(0, 1))
            full = mp_matmul.mp_fused_proj(a, ws, mode, gate=gate)
            assert _bitwise(out, one) and _bitwise(out, full[..., :M, :])
        limbs = mp_matmul.mp_decompose(b, 4)
        out, route = _routed(mp_matmul.mp_mixed_prelimbed_matmul, a[:M],
                             limbs, env, ln[:M].contiguous(),
                             lo[:M].contiguous())
        assert route == mp_matmul.SPLIT
        full = mp_matmul.mp_mixed_prelimbed_matmul(a, limbs, env, ln, lo)
        one, _ = mp_matmul.launch_mixed_routed(
            torch.cuda.current_stream().cuda_stream, a[:M], limbs, env,
            ln[:M].contiguous(), lo[:M].contiguous(), (0, 1))
        assert _bitwise(out, full[:M]) and _bitwise(out, one)
        for f in set(fmts[:M]):
            rows = [i for i, x in enumerate(fmts[:M]) if x == f]
            assert _bitwise(out[rows], mp_matmul.mp_prelimbed_matmul(
                a[rows], limbs, f)), (mode, f.name)
        if a is neg:
            assert (out[3] == 0).all() and not torch.signbit(out[3]).any()
            proj = mp_matmul.mp_fused_proj(a[:M], ws, mode)
            assert (proj[:, 3] == 0).all() and \
                not torch.signbit(proj[:, 3]).any()


# ---------------------------------------------------------------------------
# the both-prelimbed matmul's TMA + wgmma tile (csrc/mp_matmul_hopper.cu)
# against the mma.sync tile of csrc/mp_matmul.cu (the tile it replaces at
# the layouts a tensor map reads), bit for bit
# ---------------------------------------------------------------------------
BUILTIN_MODES = ["M8", "M16", "M23", "M36", "M52"]
# (M, K, N): M and N off the tiles (64 / 128 rows, 48..128 columns), K off
# the 64-k chunk; rows of a multiple of 16 bytes, as a tensor map reads them
BOTH_SHAPES = [(70, 200, 72), (130, 1000, 264), (300, 448, 200),
               (2048, 768, 768)]


def _mma_tile(al, bl, mode):
    """The both-prelimbed matmul on the mma.sync tile (the parent's)."""
    return mp_matmul.launch_both_prelimbed_matmul(
        build.load("mp_matmul"), torch.cuda.current_stream().cuda_stream,
        al, bl, resolve(mode))


def _tma_tile(al, bl, mode):
    out, route = mp_matmul.launch_both_routed(
        torch.cuda.current_stream().cuda_stream, al, bl, resolve(mode))
    assert route == mp_matmul.TMA
    return out


def _dd_stacks(M, K, N, mode, seed):
    from repro_torch.core import limbs

    rng = np.random.default_rng(seed)
    n = resolve(mode).n_limbs
    return tuple(limbs.decompose_dd(limbs.dd_from_f64(
        rng.standard_normal(shape)), n) for shape in ((M, K), (K, N)))


@pytest.mark.parametrize("M,K,N", BOTH_SHAPES)
@pytest.mark.parametrize("mode", BUILTIN_MODES)
def test_both_tma_tile_is_the_mma_tile(cuda, mode, M, K, N):
    """Every built-in format, ragged shapes: bitwise the mma.sync tile on
    the same stacks (DD stacks and stacks cut from f32), and each within
    the f32 floor of the plain version."""
    n = resolve(mode).n_limbs
    a, b = _randn(cuda, M, K, seed=200), _randn(cuda, K, N, seed=201)
    for al, bl in (_dd_stacks(M, K, N, mode, 202),
                   (mp_matmul.mp_decompose(a, n),
                    mp_matmul.mp_decompose(b, n))):
        want = _mma_tile(al, bl, mode)
        assert _bitwise(_tma_tile(al, bl, mode), want)
        _assert_mm_close(want, mp_matmul.both_prelimbed_matmul_plain(
            al, bl, mode), K)


@pytest.mark.parametrize("M,K,N,mode", [
    (2048, 768, 3072, "M36"), (2048, 768, 3072, "M52"),
    (2048, 3072, 768, "M36"), (2048, 3072, 768, "M52"),
    (2048, 768, 32000, "M52")])
def test_both_tma_tile_at_the_modes_shapes(cuda, M, K, N, mode):
    """chip_smoke.py's five [modes] DD launches: bitwise the mma.sync
    tile on decompose_dd stacks."""
    al, bl = _dd_stacks(M, K, N, mode, 203)
    assert _bitwise(_tma_tile(al, bl, mode), _mma_tile(al, bl, mode))


@pytest.mark.parametrize("M,K,N", [(2048, 768, 768), (130, 1000, 264)])
@pytest.mark.parametrize("mode", BUILTIN_MODES)
def test_both_on_f32_cut_stacks_is_the_tma_matmul_kernel(cuda, mode, M, K,
                                                         N):
    """On stacks cut from f32 operands, both-prelimbed (its TMA tile) is
    the fused matmul's TMA tile (tma_matmul_kernel) bit for bit."""
    n = resolve(mode).n_limbs
    a, b = _randn(cuda, M, K, seed=204), _randn(cuda, K, N, seed=205)
    A, B, _, sizes, strides = mp_matmul._marshal(a, b)
    assert mp_matmul.fused_route(A, B, sizes, strides) == mp_matmul.TMA
    fused = mp_matmul.mp_fused_matmul(a, b, mode)
    al, bl = mp_matmul.mp_decompose(a, n), mp_matmul.mp_decompose(b, n)
    assert _bitwise(_tma_tile(al, bl, mode), fused)


@pytest.mark.parametrize("K", [200, 1000])
@pytest.mark.parametrize("mode", ["M8", "M23", "M36", "M52"])
def test_both_rows_are_batch_invariant(cuda, mode, K):
    """Rows at M <= 17 equal the same rows of one M = 70 launch (both on
    the TMA tile), K off the chunk."""
    al, bl = _dd_stacks(70, K, 136, mode, 206)
    full = _tma_tile(al, bl, mode)
    for M in BATCH_MS:
        for rows in (slice(0, M), slice(70 - M, 70)):
            sub = al[:, rows].contiguous()
            _assert_rows_bitwise(_tma_tile(sub, bl, mode), full, rows,
                                 (M, rows))


@pytest.mark.parametrize("mode,na,nb", [("M52", 3, 7), ("M52", 7, 2),
                                        ("M36", 1, 4), ("M23", 2, 3)])
def test_both_short_stacks_are_zero_padded(cuda, mode, na, nb):
    """Stacks shorter than the format: the planes past the stored count
    read as +0.0 and their products run, so the result is the same stacks
    padded with +0.0 planes, bit for bit, and the mma.sync tile's."""
    n = resolve(mode).n_limbs
    a, b = _randn(cuda, 70, 200, seed=207), _randn(cuda, 200, 72, seed=208)
    al, bl = mp_matmul.mp_decompose(a, na), mp_matmul.mp_decompose(b, nb)

    def pad(x):
        z = torch.zeros((n - x.shape[0],) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=x.device)
        return torch.cat([x, z]) if x.shape[0] < n else x

    short = _tma_tile(al, bl, mode)
    assert _bitwise(short, _tma_tile(pad(al), pad(bl), mode))
    assert _bitwise(short, _mma_tile(al, bl, mode))


@pytest.mark.parametrize("M", [8, 70])
def test_minus_zero_and_subnormal_products_on_the_both_tile(cuda, M):
    """compare_kernels.py's two edge cases through the both-prelimbed TMA
    tile, on stacks cut from the operands: a row whose products are all
    -0.0 (it stays +0.0) and the subnormal products, bitwise the mma.sync
    tile at every format."""
    neg = _randn(cuda, 70, 256, seed=209)
    neg[3] = -0.0
    pos = _randn(cuda, 256, 64, seed=210).abs() + 0.1
    sub = _randn(cuda, 70, 16, seed=211)
    sub[0] = 3.39e38 * torch.sign(sub[0])
    sub[1, 3] = float("inf")
    sub_b = _randn(cuda, 16, 8, seed=212)
    sub_b[:, 4] = 1e-40
    for a, b in ((neg, pos), (sub, sub_b)):
        for mode in BUILTIN_MODES:
            n = resolve(mode).n_limbs
            al = mp_matmul.mp_decompose(a[:M], n)
            bl = mp_matmul.mp_decompose(b, n)
            out = _tma_tile(al, bl, mode)
            assert _bitwise(out, _mma_tile(al, bl, mode)), mode
            if a is neg:
                assert (out[3] == 0).all() and not torch.signbit(out[3]).any()


def test_both_routes_by_layout_and_format_on_the_card(cuda, custom_format):
    """The wrapper's route: the TMA tile for a built-in format's mappable
    stacks, the mma.sync tile for a run-time format, rows off 16 bytes and
    a misaligned base; each counted on its route, no plain call."""
    a, b = _randn(cuda, 70, 200, seed=213), _randn(cuda, 200, 72, seed=214)
    al, bl = mp_matmul.mp_decompose(a, 7), mp_matmul.mp_decompose(b, 7)
    odd = mp_matmul.mp_decompose(_randn(cuda, 70, 333, seed=215), 7)
    odd_b = mp_matmul.mp_decompose(_randn(cuda, 333, 72, seed=216), 7)
    shifted = mp_matmul.mp_decompose(_randn(cuda, 70, 208, seed=217), 7)
    shifted = shifted[:, :, 1:201]   # rows of 416 bytes, base off 16 bytes
    cases = [(al, bl, "M52", mp_matmul.TMA), (al, bl, CUSTOM, mp_matmul.MMA),
             (odd, odd_b, "M52", mp_matmul.MMA),
             (shifted, bl, "M52", mp_matmul.MMA)]
    kernels.reset_launch_counts()
    for x, y, mode, want in cases:
        assert mp_matmul.both_route(x, y, mode) == want
        out = mp_matmul.mp_both_prelimbed_matmul(x, y, mode)
        _assert_mm_close(out, mp_matmul.both_prelimbed_matmul_plain(
            x, y, mode), x.shape[-1])
    assert kernels.route_counts()["mp_both_prelimbed_matmul"] == {
        mp_matmul.TMA: 1, mp_matmul.MMA: 3}
    assert kernels.plain_call_counts()["mp_both_prelimbed_matmul"] == 0
    kernels.reset_launch_counts()
    # the TMA tile refuses rows no tensor map reads, and raises
    lib = build.load("mp_matmul_hopper")
    mp_matmul._set_hopper_argtypes(lib)
    args, _ = mp_matmul._both_operands(odd, odd_b)
    with pytest.raises(RuntimeError):
        build.check(lib.mp_hopper_both_prelimbed_launch(
            *args, 7, 6, torch.cuda.current_stream().cuda_stream), "both")


@pytest.mark.parametrize("mode", BUILTIN_MODES)
def test_both_tile_pins_mirror(cuda, mode):
    """The library's both-prelimbed tile (mp_both_tile) is autotune's
    mirror: rows, columns, stages, shared memory, each warpgroup's
    orders."""
    from repro_torch.kernels import autotune

    assert mp_matmul.both_tile(mode) == autotune.both_tile(mode)
