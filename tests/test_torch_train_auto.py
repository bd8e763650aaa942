"""PyTorch port: AUTO (paper mode 1) under training, held against the JAX
package's ``mp_matmul_auto`` on the same numpy inputs.

JAX's AUTO is a ``lax.switch`` over differentiable static branches, so its
gradient is the selected branch's at that branch's backward formats.  The
port reads the selected index back to the host and runs the static
differentiable op.  Gradients are held at ``torch_parity``'s kernel-vs-
oracle tolerance (as in tests/test_torch_grad.py), a SMOKE training step
under ``PrecisionPolicy.auto()`` at tests/test_torch_train.py's bounds
(loss 1e-5 relative, each gradient leaf 5e-4 of its max).  Inside the port
the invariants are bitwise: remat on == off, and remat's recompute must
select what the forward selected."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_mpfp as jconfigs
from repro.core import auto as jauto
from repro.core import context as jcontext
from repro.core import mpmatmul as jmp
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as JT
from repro.train import trainer as jtrainer
from repro_torch import kernels
from repro_torch import tree as tree_lib
from repro_torch.configs import paper_mpfp
from repro_torch.core import auto as pauto
from repro_torch.core import mpmatmul as pmp
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.train import trainer as trainer_lib
from repro_torch.weights import params_from_jax
from torch_parity import assert_matmul_close

CFG = paper_mpfp.SMOKE
GRAD_BOUND = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one thread, as the suite's workers share
    the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _operands(kind, sa, sb, seed=0):
    """Operand classes that make AUTO pick each candidate: integers and
    bf16 values (one limb, M8), two-limb values (M16), raw f32 (M23)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(sa).astype(np.float32)
    b = rng.standard_normal(sb).astype(np.float32)
    if kind == "integers":
        a, b = np.round(a * 4), np.round(b * 4)
    elif kind == "bf16":
        a, b = (torch.from_numpy(x).bfloat16().float().numpy()
                for x in (a, b))
    elif kind == "two limbs":
        def two(x):
            t = torch.from_numpy(x)
            hi = t.bfloat16().float()
            return (hi + (t - hi).bfloat16().float()).numpy()
        a, b = two(a), two(b)
    return a.astype(np.float32), b.astype(np.float32)


SHAPES = {"2d": ((17, 40), (40, 23)),
          "3d x 2d": ((3, 17, 40), (40, 23)),
          "both batched": ((2, 3, 17, 40), (2, 3, 40, 23))}
# (the default tolerance 2^-13 takes raw f32 normals at two limbs)
KINDS = {"integers": "M8", "bf16": "M8", "two limbs": "M16", "f32": "M16"}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_auto_gradients_match_jax(shape, kind):
    """Value and both gradients of AUTO against ``jax.grad`` of JAX's
    ``mp_matmul_auto``; the selection is JAX's."""
    sa, sb = SHAPES[shape]
    a, b = _operands(kind, sa, sb, seed=len(shape))
    out_shape = np.broadcast_shapes(sa[:-2], sb[:-2]) + (sa[-2], sb[-1])
    w = np.random.default_rng(7).standard_normal(out_shape).astype(
        np.float32)
    assert jauto.auto_report(a, b)["selected_format"] == KINDS[kind]
    assert pauto.auto_report(torch.from_numpy(a), torch.from_numpy(b))[
        "selected_format"] == KINDS[kind]

    def jloss(x, y):
        return jnp.sum(jmp.mp_matmul(x, y, "AUTO", backend="ref") * w)

    jv, (ga, gb) = jax.value_and_grad(jloss, argnums=(0, 1))(a, b)
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    out = pmp.mp_matmul(ta, tb, "AUTO")
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    assert abs(loss.item() - float(jv)) <= 1e-5 * (abs(float(jv)) + 1)
    assert_matmul_close(ta.grad, ga)
    assert_matmul_close(tb.grad, gb)


def test_auto_gradients_at_a_tight_tolerance_match_jax():
    """At ``auto_tol`` 2^-20 raw f32 takes three limbs (M23) in both
    packages; the gradients against ``jax.grad``."""
    from repro_torch.core import context as pcontext

    a, b = _operands("f32", (3, 17, 40), (40, 23), seed=9)
    w = np.random.default_rng(10).standard_normal((3, 17, 23)).astype(
        np.float32)
    with jcontext.context(auto_tol=2.0 ** -20):
        assert jauto.auto_report(a, b)["selected_format"] == "M23"
        ga, gb = jax.grad(lambda x, y: jnp.sum(jmp.mp_matmul(
            x, y, "AUTO", backend="ref") * w), argnums=(0, 1))(a, b)
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    with pcontext.context(auto_tol=2.0 ** -20):
        (pmp.mp_matmul(ta, tb, "AUTO") * torch.from_numpy(w)).sum() \
            .backward()
    assert_matmul_close(ta.grad, ga)
    assert_matmul_close(tb.grad, gb)


@pytest.mark.parametrize("dg,wg", [("M8", "M23"), ("M23", "M16")])
def test_auto_gradients_at_named_backward_formats_match_jax(dg, wg):
    """Named dgrad / wgrad formats reach the selected branch, as
    ``mp_matmul_auto``'s do in JAX."""
    a, b = _operands("bf16", (3, 9, 33), (33, 12), seed=5)
    w = np.random.default_rng(8).standard_normal((3, 9, 12)).astype(
        np.float32)

    def jloss(x, y):
        return jnp.sum(jmp.mp_matmul(x, y, "AUTO", dgrad_mode=dg,
                                     wgrad_mode=wg, backend="ref") * w)

    ga, gb = jax.grad(jloss, argnums=(0, 1))(a, b)
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    (pmp.mp_matmul(ta, tb, "AUTO", dgrad_mode=dg, wgrad_mode=wg)
     * torch.from_numpy(w)).sum().backward()
    assert_matmul_close(ta.grad, ga)
    assert_matmul_close(tb.grad, gb)
    # the selected branch (M8) at those formats, bitwise
    sa = torch.tensor(a, requires_grad=True)
    sb = torch.tensor(b, requires_grad=True)
    (pmp.mp_matmul(sa, sb, "M8", dgrad_mode=dg, wgrad_mode=wg)
     * torch.from_numpy(w)).sum().backward()
    assert torch.equal(sa.grad, ta.grad) and torch.equal(sb.grad, tb.grad)


def test_auto_swiglu_and_qkv_gradients_match_jax():
    """The per-branch AUTO path of the fused projections differentiates:
    SwiGLU with a residual, and QKV, against ``jax.grad``."""
    rng = np.random.default_rng(11)
    x, wg_, wu, res, t = (rng.standard_normal(s).astype(np.float32)
                          for s in ((2, 5, 32), (32, 24), (32, 24),
                                    (2, 5, 24), (2, 5, 24)))

    def jloss(x, g, u, r):
        return jnp.sum(jmp.mp_swiglu(x, g, u, "AUTO", residual=r,
                                     backend="ref") * t)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(x, wg_, wu, res)
    leaves = [torch.tensor(v, requires_grad=True) for v in (x, wg_, wu, res)]
    out = pmp.mp_swiglu(leaves[0], leaves[1], leaves[2], "AUTO",
                        residual=leaves[3])
    (out * torch.from_numpy(t)).sum().backward()
    for p, j in zip(leaves, jg):
        assert_matmul_close(p.grad, j)
    ws = [rng.standard_normal((32, 16)).astype(np.float32) for _ in range(3)]
    ts = [rng.standard_normal((2, 5, 16)).astype(np.float32)
          for _ in range(3)]

    def jqkv(x, *w):
        return sum(jnp.sum(o * tt) for o, tt in zip(
            jmp.mp_qkv_proj(x, *w, "AUTO", backend="ref"), ts))

    jg = jax.grad(jqkv, argnums=(0, 1, 2, 3))(x, *ws)
    leaves = [torch.tensor(v, requires_grad=True) for v in (x, *ws)]
    outs = pmp.mp_qkv_proj(*leaves, "AUTO")
    sum((o * torch.from_numpy(tt)).sum() for o, tt in zip(outs, ts)) \
        .backward()
    for p, j in zip(leaves, jg):
        assert_matmul_close(p.grad, j)


# =========================================================================
# the SMOKE training step under PrecisionPolicy.auto()
# =========================================================================
@pytest.fixture(scope="module")
def jax_params():
    return JT.init_params(jconfigs.SMOKE, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _batch(step=0, seq=17, batch=4):
    pipe = SyntheticLM(DataConfig(vocab=CFG.vocab, seq_len=seq,
                                  global_batch=batch))
    return pipe.batch(step)


def _grads(params, batch, cfg=CFG, policy=None):
    loss_fn = trainer_lib.make_loss_fn(cfg, policy or PrecisionPolicy.auto())
    return trainer_lib.value_and_grad(
        loss_fn, params, {k: torch.from_numpy(v) for k, v in batch.items()})


def test_smoke_auto_loss_and_gradients_match_jax(jax_params, params):
    """A SMOKE value-and-grad under ``auto()`` (every class AUTO but
    lm_head; attention on the chunk-scan) against JAX's on its ``ref``
    backend."""
    batch = _batch()
    jloss_fn = jtrainer.make_loss_fn(jconfigs.SMOKE, JPolicy.auto(),
                                     jtrainer.TrainerConfig())
    with jcontext.context(backend="ref"):
        (jl, _), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
            jax_params, {k: jnp.asarray(v) for k, v in batch.items()})
    (pl, _), pg = _grads(params, batch)
    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for g, w in zip(tree_lib.leaves(pg), tree_lib.leaves(want)):
        w = w.numpy()
        err = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-30)
        assert err < GRAD_BOUND, err


def test_smoke_auto_trainer_step_matches_jax(jax_params, params):
    """One ``Trainer`` step under ``auto()``: the loss and every updated
    parameter against JAX's step (AdamW at rtol 5e-4 of each leaf's
    max)."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw

    batch = _batch(1)
    jt = jtrainer.Trainer(jconfigs.SMOKE, jtrainer.TrainerConfig(
        total_steps=10, warmup=2, matmul_backend="ref"),
        policy=JPolicy.auto())
    jstate = jtrainer.TrainState(jax_params,
                                 jadamw.init(jax_params, jadamw.AdamWConfig()))
    jnew, jm = jt._step_fn(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    pt = trainer_lib.Trainer(CFG, trainer_lib.TrainerConfig(
        total_steps=10, warmup=2), policy=PrecisionPolicy.auto(),
        device="cpu")
    pstate = trainer_lib.TrainState(params, adamw.init(params,
                                                       adamw.AdamWConfig()))
    pnew, pm = pt._step_fn(pstate, pt.to_device(batch))
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jnew.params))
    for p, w in zip(tree_lib.leaves(pnew.params), tree_lib.leaves(want)):
        w = w.numpy()
        assert np.abs(p.numpy() - w).max() <= GRAD_BOUND * np.abs(w).max()


def test_auto_remat_gives_the_bits_of_no_remat(params):
    batch = _batch(2)
    (l_on, _), g_on = _grads(params, batch)
    (l_off, _), g_off = _grads(params, batch,
                               cfg=dataclasses.replace(CFG, remat=False))
    assert CFG.remat and torch.equal(l_on, l_off)
    for a, b in zip(tree_lib.leaves(g_on), tree_lib.leaves(g_off)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _pairs(seq):
    return (seq // CFG.attn_q_chunk) * (seq // CFG.attn_kv_chunk)


@pytest.mark.parametrize("remat", [True, False])
def test_auto_step_reads_and_calls_are_the_formula(params, remat):
    """Host reads per step: one per AUTO matmul of the forward (QKV 3, wo,
    gate, up, w_down, and QK and PV per chunk pair: 7 + 2 pairs a layer),
    again in remat's recompute; the backward reads nothing.  Kernel calls
    (here the plain versions): those 9 in the forward (twice with remat),
    the dgrads (7) and both operands' gradients of QK and PV per pair
    (4 pairs), lm_head forward and dgrad; no projection or flash call."""
    cfg = dataclasses.replace(CFG, remat=remat)
    pairs, L = _pairs(16), CFG.n_layers
    kernels.reset_launch_counts()
    _grads(params, _batch(3), cfg=cfg)
    fwd = (7 + 2 * pairs) * (2 if remat else 1)
    assert pauto.mp_matmul_auto.host_reads == fwd * L
    calls = {k: v for k, v in kernels.plain_call_counts().items() if v}
    assert calls == {"mp_fused_matmul": L * (fwd + 7 + 4 * pairs) + 2}


def test_remat_recompute_must_select_what_the_forward_selected(params,
                                                               monkeypatch):
    """The recompute analyzes the operands again; a different selection
    there raises instead of training on other formats."""
    batch = _batch(4)
    real = pauto.select_mode_index
    calls, forward = {"n": 0}, (7 + 2 * _pairs(16)) * CFG.n_layers

    def drifting(a, b, candidates=None, *, tol=None):
        calls["n"] += 1
        idx = real(a, b, candidates, tol=tol)
        if calls["n"] > forward:
            return (idx + 1) % 3  # the recompute's selections move
        return idx

    monkeypatch.setattr(pauto, "select_mode_index", drifting)
    with pytest.raises(RuntimeError, match="AUTO recompute selected"):
        _grads(params, batch)


def test_selection_log_records_then_checks():
    log = pauto.SelectionLog()
    with log.recording():
        for i in (0, 2, 1):
            log.note(i)
    with log.replaying():
        for i in (0, 2, 1):
            log.note(i)
    with pytest.raises(RuntimeError, match="candidate 0 at call 1"):
        with log.replaying():
            log.note(0)
            log.note(0)
    with pytest.raises(RuntimeError, match="made 1 selections"):
        with log.replaying():
            log.note(0)


def test_train_launcher_runs_under_auto(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --policy auto --device
    cpu`` (two steps)."""
    state, hist = launch_train.main(
        ["--smoke", "--policy", "auto", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert "done: loss" in capsys.readouterr().out


def test_auto_policy_backward_formats_are_jax():
    """Under ``auto()`` each class's backward formats are JAX's: none named
    for the AUTO classes (the selected format's own), ``lm_head`` at its
    built-in M23."""
    p, j = PrecisionPolicy.auto(), JPolicy.auto()
    for cls in ("qkv", "attn_qk", "attn_pv", "attn_out", "ffn", "lm_head",
                "moe_expert", "ssm"):
        pk, jk = p.bwd_kwargs(cls), j.bwd_kwargs(cls)
        assert pk.keys() == jk.keys()
        for k in pk:
            assert getattr(pk[k], "name", pk[k]) == \
                getattr(jk[k], "name", jk[k]), (cls, k)
    assert p.bwd_kwargs("qkv") == {"dgrad_mode": None, "wgrad_mode": None}
