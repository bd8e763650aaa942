"""PyTorch port: the differentiable multi-precision ops and the training
substrate, held against the JAX package on the same numpy inputs.

Gradients: the JAX side is ``jax.grad`` on the ``ref`` backend; the port
runs its default backend on CPU tensors, so its forward kernels' plain
versions, and the backward dispatch calls at the dgrad/wgrad formats
(``core/mpmatmul.py``).  Matmul and projection gradients are held at
``torch_parity.assert_matmul_close`` (tests/test_kernels.py's
kernel-vs-oracle tolerance: the two sum the same exact limb products in
another order), attention gradients at ``assert_attention_close``.  Beside
them: ``_unbroadcast``, ``classify`` / ``all_finite`` (subnormals on numpy
bit patterns: XLA on the CPU flushes them), one AdamW update at rtol 1e-6,
the schedules, the synthetic pipeline bitwise, and the training policies."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.classify import classify as jax_classify
from repro.core import mpmatmul as jmp
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch.core import classify as pclassify
from repro_torch.core import mpmatmul as pmp
from repro_torch.core.policy import POLICIES, PrecisionPolicy
from repro_torch.data import pipeline as ppipe
from repro_torch.kernels import ref as pref
from repro_torch.optim import adamw as padamw
from repro_torch.optim import schedule as psched
from torch_parity import assert_attention_close, assert_matmul_close

# (fwd, dgrad, wgrad): every built-in f32 format forward, the two backward
# formats different from it and from each other
FMTS = (("M8", "M16", "M23"), ("M16", "M8", "M23"), ("M23", "M16", "M8"))

MATMUL_SHAPES = {
    "2d": ((17, 40), (40, 23)),
    "3d x 2d": ((3, 17, 40), (40, 23)),
    "both batched": ((2, 3, 17, 40), (2, 3, 40, 23)),
    "broadcast batch": ((3, 17, 40), (2, 3, 40, 23)),
    "size-1 batch": ((2, 1, 17, 40), (1, 3, 40, 23)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: on one thread, as the suite's workers share
    the machine's cores (PyTorch's default pool, one thread per core in
    every worker, made these tests 10-60x slower under the parallel run)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _leaf(x):
    return torch.tensor(x, requires_grad=True)


@pytest.mark.parametrize("fmts", FMTS, ids=lambda f: "/".join(f))
@pytest.mark.parametrize("shape", list(MATMUL_SHAPES))
def test_mp_matmul_gradients_match_jax(shape, fmts):
    fwd, dg, wg = fmts
    sa, sb = MATMUL_SHAPES[shape]
    a, b = _np(sa, sb, seed=len(shape))
    out_shape = np.broadcast_shapes(sa[:-2], sb[:-2]) + (sa[-2], sb[-1])
    (w,) = _np(out_shape, seed=7)

    def jloss(x, y):
        return jnp.sum(jmp.mp_matmul(x, y, fwd, dgrad_mode=dg, wgrad_mode=wg,
                                     backend="ref") * w)

    ga, gb = jax.grad(jloss, argnums=(0, 1))(a, b)
    ta, tb = _leaf(a), _leaf(b)
    out = pmp.mp_matmul(ta, tb, fwd, dgrad_mode=dg, wgrad_mode=wg)
    (out * torch.from_numpy(w)).sum().backward()
    assert_matmul_close(ta.grad, ga)
    assert_matmul_close(tb.grad, gb)


def test_bwd_mode_is_the_default_of_both_backward_formats():
    """``bwd_mode`` drives dgrad and wgrad unless they are named, as in the
    JAX package; the forward alone never builds a graph."""
    a, b, w = _np((2, 9, 33), (33, 12), (2, 9, 12), seed=3)

    def grads(**kw):
        ta, tb = _leaf(a), _leaf(b)
        (pmp.mp_matmul(ta, tb, "M8", **kw) * torch.from_numpy(w)).sum() \
            .backward()
        return ta.grad, tb.grad

    via_bwd = grads(bwd_mode="M23")
    named = grads(dgrad_mode="M23", wgrad_mode="M23")
    assert all(torch.equal(x, y) for x, y in zip(via_bwd, named))
    assert not torch.equal(via_bwd[0], grads()[0])
    with torch.no_grad():
        assert pmp.mp_matmul(_leaf(a), _leaf(b), "M8").grad_fn is None


def test_auto_under_autograd_is_not_ported_yet():
    """AUTO under autograd is ported now (the name is kept from when it
    raised): the gradient is the selected static format's, bitwise, and
    the forward reads the selection back once (tests/test_torch_train_auto.py
    holds it against ``jax.grad``)."""
    from repro_torch.core import auto as pauto

    a, b = _np((4, 8), (8, 3))
    a, b = np.round(a * 4), np.round(b * 4)  # integers: AUTO selects M8
    pauto.mp_matmul_auto.host_reads = 0
    ta = _leaf(a)
    pmp.mp_matmul(ta, torch.from_numpy(b), "AUTO").sum().backward()
    assert pauto.mp_matmul_auto.host_reads == 1
    ts = _leaf(a)
    pmp.mp_matmul(ts, torch.from_numpy(b), "M8").sum().backward()
    assert torch.equal(ta.grad, ts.grad)


@pytest.mark.parametrize("fmts", FMTS[:2], ids=lambda f: "/".join(f))
@pytest.mark.parametrize("lead", [(5,), (2, 5)], ids=["2d", "3d"])
def test_fused_qkv_gradients_with_biases_match_jax(lead, fmts):
    fwd, dg, wg = fmts
    K, N = 32, 24
    x, *rest = _np(lead + (K,), *[(K, N)] * 3, *[(N,)] * 3,
                   *[lead + (N,)] * 3, seed=11)
    ws, bs, wts = rest[:3], rest[3:6], rest[6:]

    def jloss(x, ws, bs):
        outs = jmp.mp_qkv_proj(x, *ws, fwd, biases=bs, dgrad_mode=dg,
                               wgrad_mode=wg, backend="ref")
        return sum(jnp.sum(o * t) for o, t in zip(outs, wts))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(x, tuple(ws), tuple(bs))
    tx, tws, tbs = _leaf(x), [_leaf(w) for w in ws], [_leaf(b) for b in bs]
    outs = pmp.mp_qkv_proj(tx, *tws, fwd, biases=tbs, dgrad_mode=dg,
                           wgrad_mode=wg)
    sum((o * torch.from_numpy(t)).sum() for o, t in zip(outs, wts)) \
        .backward()
    assert_matmul_close(tx.grad, jg[0])
    for t, j in zip(tws + tbs, list(jg[1]) + list(jg[2])):
        assert_matmul_close(t.grad, j)


@pytest.mark.parametrize("fmts", FMTS[:2], ids=lambda f: "/".join(f))
def test_fused_swiglu_gradients_with_residual_match_jax(fmts):
    fwd, dg, wg = fmts
    B, S, K, N = 2, 5, 32, 48
    x, wgate, wup, res, wt = _np((B, S, K), (K, N), (K, N), (B, S, N),
                                 (B, S, N), seed=13)

    def jloss(x, wgate, wup, res):
        out = jmp.mp_swiglu(x, wgate, wup, fwd, residual=res, dgrad_mode=dg,
                            wgrad_mode=wg, backend="ref")
        return jnp.sum(out * wt)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(x, wgate, wup, res)
    tx, tg, tu, tr = (_leaf(v) for v in (x, wgate, wup, res))
    out = pmp.mp_swiglu(tx, tg, tu, fwd, residual=tr, dgrad_mode=dg,
                        wgrad_mode=wg)
    (out * torch.from_numpy(wt)).sum().backward()
    for t, j in zip((tx, tg, tu, tr), jg):
        assert_matmul_close(t.grad, j)


ATTN_CASES = pytest.mark.parametrize("causal,q_offset,S,T", [
    (True, 0, 24, 24), (False, 0, 24, 40), (True, 16, 24, 40)],
    ids=["causal", "bidirectional", "causal q_offset"])
ATTN_BWD_KEYS = ("dgrad_qk_mode", "wgrad_qk_mode", "dgrad_pv_mode",
                 "wgrad_pv_mode")
# M8 backward, norm-wise: a one-unit bf16 change (2^-8 relative) on one
# element in 1,024, ||port - jax|| / ||jax|| per gradient
M8_BWD_NORM_BOUND = 2.0 ** -8 * (1 / 1024) ** 0.5


def _attention_grads(q, k, v, wt, causal, q_offset, kw):
    """(jax.grad on the ref backend, the port's autograd) of
    sum(mp_attention(q, k, v, M16, M8) * wt) for q, k and v."""
    def jloss(q, k, v):
        out = jmp.mp_attention(q, k, v, "M16", "M8", backend="ref",
                               causal=causal, q_offset=q_offset, **kw)
        return jnp.sum(out * wt)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    out = pmp.mp_attention(tq, tk, tv, "M16", "M8", causal=causal,
                           q_offset=q_offset, **kw)
    (out * torch.from_numpy(wt)).sum().backward()
    return [np.asarray(j) for j in jg], [t.grad.numpy()
                                         for t in (tq, tk, tv)]


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@ATTN_CASES
def test_mp_attention_gradients_match_jax(causal, q_offset, S, T):
    """Forward M16/M8, the four backward products at their own formats.
    Three of them limb a computed intermediate (P, dS), which the two
    packages sum in other orders; at M8 a one-unit difference there can
    move a bf16 rounding (the P-rounding trap of the paged kernels, ROADMAP
    Queue 3), so the backward formats here keep two limbs or more."""
    B, H, Dh = 2, 3, 16
    q, k, v, wt = _np((B, S, H, Dh), (B, T, H, Dh), (B, T, H, Dh),
                      (B, S, H, Dh), seed=17)
    kw = dict(dgrad_qk_mode="M23", wgrad_qk_mode="M16", dgrad_pv_mode="M16",
              wgrad_pv_mode="M23")
    jg, pg = _attention_grads(q, k, v, wt, causal, q_offset, kw)
    for p, j in zip(pg, jg):
        assert_attention_close(p, j)


@ATTN_CASES
def test_mp_attention_m8_backward_matches_jax_normwise(causal, q_offset, S,
                                                       T):
    """All four backward products at M8 (train_fast's attn_out runs its
    P.V backward there), held against jax.grad norm-wise: a one-unit bf16
    rounding of P or dS that the two packages' sum orders place on either
    side of a boundary stays far inside M8_BWD_NORM_BOUND, while any one
    product at M16 instead of M8 moves its gradients by more than ten times
    the bound (checked here on the JAX side), so a port that ran another
    format than the one asked would fail."""
    B, H, Dh = 2, 3, 16
    q, k, v, wt = _np((B, S, H, Dh), (B, T, H, Dh), (B, T, H, Dh),
                      (B, S, H, Dh), seed=17)
    m8 = dict.fromkeys(ATTN_BWD_KEYS, "M8")
    jg, pg = _attention_grads(q, k, v, wt, causal, q_offset, m8)
    for name, p, j in zip("qkv", pg, jg):
        assert _norm_rel(p, j) <= M8_BWD_NORM_BOUND, name
    # which of dq, dk, dv each product feeds
    feeds = {"dgrad_qk_mode": "q", "wgrad_qk_mode": "k",
             "dgrad_pv_mode": "qk", "wgrad_pv_mode": "v"}
    for key, names in feeds.items():
        jg16, _ = _attention_grads(q, k, v, wt, causal, q_offset,
                                   {**m8, key: "M16"})
        for name in names:
            i = "qkv".index(name)
            assert _norm_rel(jg[i], jg16[i]) > 10 * M8_BWD_NORM_BOUND, (
                key, name)


@pytest.mark.parametrize("shape,target", [
    ((4, 3), (4, 3)), ((2, 5, 3), (5, 3)), ((2, 4, 5, 3), (4, 1, 3)),
    ((2, 4, 5, 3), (1, 4, 5, 1)), ((6, 2, 3), (2, 1))])
def test_unbroadcast_matches_jax(shape, target):
    (x,) = _np(shape, seed=19)
    want = np.asarray(jmp._unbroadcast(jnp.asarray(x), target))
    got = pmp._unbroadcast(torch.from_numpy(x), target).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _bits(u32):
    return np.asarray(u32, np.uint32).view(np.float32)


def test_classify_on_bit_patterns():
    x = _bits([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
               0xFFC00001, 0x3F800000, 0xC0490FDB, 0x00000001, 0x807FFFFF,
               0x00800000])
    s = pclassify.classify(torch.from_numpy(x))
    bits = x.view(np.uint32)
    exp, sig = (bits >> 23) & 0xFF, bits & 0x7FFFFF
    np.testing.assert_array_equal(s.zero.numpy(), (exp == 0) & (sig == 0))
    np.testing.assert_array_equal(s.infinity.numpy(),
                                  (exp == 0xFF) & (sig == 0))
    np.testing.assert_array_equal(s.nan.numpy(), (exp == 0xFF) & (sig != 0))
    np.testing.assert_array_equal(s.denormal.numpy(),
                                  (exp == 0) & (sig != 0))
    assert s.denormal.numpy().sum() == 2
    # away from subnormals the JAX package's masks, bit for bit
    normal = x[np.isin(np.arange(x.size), [0, 1, 2, 3, 4, 5, 6, 7, 10])]
    js = jax_classify(jnp.asarray(normal))
    ps = pclassify.classify(torch.from_numpy(normal))
    for name in ("zero", "infinity", "nan", "denormal"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      np.asarray(getattr(js, name)))
    counts = pclassify.exception_counts(torch.from_numpy(x))
    assert {k: int(v) for k, v in counts.items()} == {
        "zero": 2, "infinity": 2, "nan": 2, "denormal": 2}


def test_all_finite_over_trees():
    ok = {"a": torch.ones(3), "b": [torch.zeros(2, 2), torch.tensor(1.0)],
          "n": torch.arange(3)}
    assert bool(pclassify.all_finite(ok))
    for bad in (float("nan"), float("inf"), -float("inf")):
        tree = {"a": torch.ones(3), "b": [torch.tensor([0.0, bad])]}
        assert not bool(pclassify.all_finite(tree))
    assert bool(pclassify.all_finite({"n": torch.arange(3)}))
    sub = torch.from_numpy(_bits([0x00000001]))
    assert bool(pclassify.all_finite([sub]))


def _opt_tree(seed):
    a, b, c = _np((7, 5), (5,), (3, 2, 4), seed=seed)
    return {"w": a, "b": b, "layers": {"k": c}}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_adamw_apply_matches_jax(moments, clip):
    params, grads = _opt_tree(23), _opt_tree(29)
    grads = {k: (v * 3 if k == "w" else v) for k, v in grads.items()}
    jcfg = jadamw.AdamWConfig(lr=1e-2, grad_clip=clip, moment_dtype=moments)
    pcfg = padamw.AdamWConfig(lr=1e-2, grad_clip=clip, moment_dtype=moments)
    to_t = lambda tree: {k: to_t(v) if isinstance(v, dict)  # noqa: E731
                         else torch.from_numpy(v) for k, v in tree.items()}
    jstate = jadamw.init(params, jcfg)
    pstate = padamw.init(to_t(params), pcfg)
    for step in range(3):  # moments and bias corrections past step 1
        scale = jsched.warmup_cosine(step, warmup=2, total=10)
        jp, jstate, jm = jadamw.apply(params, grads, jstate, jcfg, scale)
        pp, pstate, pm = padamw.apply(
            to_t(params), to_t(grads), pstate, pcfg,
            psched.warmup_cosine(step, warmup=2, total=10))
        params = jax.tree_util.tree_map(np.asarray, jp)
        for j, p in zip(jax.tree_util.tree_leaves(jp), [
                pp["b"], pp["layers"]["k"], pp["w"]]):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)
        for tree_j, tree_p in ((jstate.m, pstate.m), (jstate.v, pstate.v)):
            for j, p in zip(jax.tree_util.tree_leaves(tree_j), [
                    tree_p["b"], tree_p["layers"]["k"], tree_p["w"]]):
                assert str(p.dtype).endswith(moments)
                np.testing.assert_allclose(
                    p.float().numpy(), np.asarray(j, np.float32), rtol=1e-6,
                    atol=1e-12)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(pstate.step) == int(jstate.step) == step + 1


def test_schedules_match_jax():
    for s in (0, 1, 2, 5, 50, 99, 100, 101, 500, 999, 1000, 1500):
        for name in ("warmup_cosine", "constant"):
            j = float(jsched.SCHEDULES[name](s, warmup=100, total=1000))
            p = float(psched.SCHEDULES[name](s, warmup=100, total=1000))
            np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-7)
    step = torch.tensor(7, dtype=torch.int32)
    assert float(psched.warmup_cosine(step, warmup=4, total=20)) == float(
        psched.warmup_cosine(7, warmup=4, total=20))


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_synthetic_pipeline_is_bitwise_jax(rank, world, tmp_path):
    kw = dict(vocab=256, seq_len=17, global_batch=4, seed=5)
    j = jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    p = ppipe.make_pipeline(ppipe.DataConfig(**kw))
    for step in (0, 3, 11):
        jb, pb = j.batch(step, rank, world), p.batch(step, rank, world)
        assert jb.keys() == pb.keys()
        for k in jb:
            assert jb[k].dtype == pb[k].dtype
            np.testing.assert_array_equal(jb[k], pb[k])
    # the memmap kind is ported too: make_pipeline builds it, and its
    # batches are JAX's (tests/test_torch_modes_context.py holds more)
    path = tmp_path / "tokens.bin"
    np.random.default_rng(rank).integers(0, 256, 2000).astype(
        np.uint32).tofile(path)
    mkw = dict(kw, kind="memmap", path=str(path))
    jm = jpipe.make_pipeline(jpipe.DataConfig(**mkw))
    pm = ppipe.make_pipeline(ppipe.DataConfig(**mkw))
    assert isinstance(pm, ppipe.MemmapLM)
    for step in (0, 3):
        jb, pb = jm.batch(step, rank, world), pm.batch(step, rank, world)
        for k in jb:
            np.testing.assert_array_equal(jb[k], pb[k])
    with pytest.raises(ValueError, match="unknown pipeline kind"):
        ppipe.make_pipeline(ppipe.DataConfig(kind="parquet", **kw))


@pytest.mark.parametrize("name", ["train_default", "train_fast"])
def test_training_policies_match_jax(name):
    import json

    assert json.loads(POLICIES[name]().to_json()) == json.loads(
        getattr(JPolicy, name)().to_json())


def test_bwd_kwargs_match_jax():
    rules = {"ffn": {"fwd": "M8", "wgrad": "M23"}, "qkv": "M16",
             "attn_logits": {"fwd": "M16", "dgrad": "M8"}}
    jp = JPolicy(rules, bwd_dgrad="M16")
    pp = PrecisionPolicy(rules, bwd_dgrad="M16")
    for cls in ("ffn", "qkv", "attn_qk", "attn_pv", "lm_head", "other"):
        want = {k: None if v is None else v.name
                for k, v in jp.bwd_kwargs(cls).items()}
        got = {k: None if v is None else v.name
               for k, v in pp.bwd_kwargs(cls).items()}
        assert got == want, cls
        assert (pp.bwd(cls) and pp.bwd(cls).name) == \
            (jp.bwd(cls) and jp.bwd(cls).name)


@pytest.mark.parametrize("fmt", ["M8", "M16", "M23"])
def test_wgrad_ref_matches_jax(fmt):
    from repro.kernels import ref as jref

    a, g = _np((3, 5, 40), (3, 5, 24), seed=31)
    want = np.asarray(jref.mp_wgrad_ref(jnp.asarray(a), jnp.asarray(g), fmt))
    got = pref.mp_wgrad_ref(torch.from_numpy(a), torch.from_numpy(g), fmt)
    assert got.dtype == torch.float32
    assert_matmul_close(got, want)
    with pytest.raises(ValueError, match="leading dims"):
        pref.mp_wgrad_ref(torch.from_numpy(a), torch.from_numpy(g[:2]), fmt)
