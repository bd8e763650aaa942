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
from repro_torch.kernels import mp_attention, mp_matmul
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


@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M36", "M52", CUSTOM])
def test_fused_matmul_kernel_matches_plain(cuda, custom_format, mode):
    a, b = _randn(cuda, 130, 200, seed=1), _randn(cuda, 200, 70, seed=2)
    before = mp_matmul.mp_fused_matmul.launches
    out = mp_matmul.mp_fused_matmul(a, b, mode)
    assert mp_matmul.mp_fused_matmul.launches == before + 1
    _assert_mm_close(out, mp_matmul.fused_matmul_plain(a, b, mode), 200)


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


@pytest.mark.parametrize("mode,n_stored", [
    ("M8", 1), ("M8", 2), ("M16", 1), ("M16", 2), ("M23", 4), ("M36", 3),
    (CUSTOM, 4)])
def test_prelimbed_kernel_matches_plain_and_fused(cuda, custom_format, mode,
                                                  n_stored):
    """Held at the f32 floor against the plain version, and bitwise against
    the fused kernel on the raw weight whenever the stack holds every limb
    the format needs."""
    a, w = _randn(cuda, 70, 200, seed=61), _randn(cuda, 200, 90, seed=62)
    limbs = mp_matmul.mp_decompose(w, n_stored)
    before = mp_matmul.mp_prelimbed_matmul.launches
    out = mp_matmul.mp_prelimbed_matmul(a, limbs, mode)
    assert mp_matmul.mp_prelimbed_matmul.launches == before + 1
    _assert_mm_close(out, mp_matmul.prelimbed_matmul_plain(a, limbs, mode),
                     200)
    if n_stored >= resolve(mode).n_limbs:
        assert torch.equal(out, mp_matmul.mp_fused_matmul(a, w, mode))


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
    (8, 768, 768, 5), (13, 300, 77, 4), (8, 200, 90, 2)])
def test_mixed_prelimbed_rows_are_the_homogeneous_kernel(
        cuda, custom_format, M, K, N, n_stored):
    """Each row of the mixed kernel is bit for bit the pre-limbed kernel's
    row at its own format (zero signs included; rows past the table's end
    at PAD_LANE), and the whole output is held at the f32 floor against
    the plain version."""
    fmts = [resolve(m) for m in (MIXED_ROWS * 2)[:M]]
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
