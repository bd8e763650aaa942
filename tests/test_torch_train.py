"""PyTorch port: the training slice end to end against the JAX package, and
ports of the JAX package's training tests.

From ``params_from_jax`` of one JAX init and one synthetic batch at SMOKE
size, under ``train_default``, the JAX side on its ``ref`` backend and the
port on CPU tensors (its kernels' plain versions):

* the loss within 1e-5 relative;
* every gradient leaf within a max-abs error of 5e-4 of the leaf's max
  (tests/test_fault_tolerance.py's bound for two sum orders of one
  gradient);
* four ``Trainer.run`` steps' losses within 5e-4 relative.

Then the JAX training tests' claims on the port alone (loss falls, restart
resumes, a NaN step rolls back and escalates to ``full_fp32``, microbatches
equal the full batch, remat gives the bits of no remat), the launch counts
per step that ``chip_smoke.py`` holds on the card (here the plain-version
counts), the checkpoint format, and the backward's independence from the
caller's precision scopes."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_mpfp as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer
from repro_torch import kernels
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import paper_mpfp
from repro_torch.core import context as context_lib
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib
from repro_torch.weights import adamw_state_from_jax, params_from_jax

CFG = paper_mpfp.SMOKE
GRAD_BOUND = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: on one thread, as the suite's workers share
    the machine's cores (PyTorch's default pool, one thread per core in
    every worker, made these tests 10-60x slower under the parallel run)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    return JT.init_params(jconfigs.SMOKE, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def np_params(jax_params):
    return jax.tree_util.tree_map(np.asarray, jax_params)


def _pipe(seq=17, batch=4):
    return SyntheticLM(DataConfig(vocab=CFG.vocab, seq_len=seq,
                                  global_batch=batch))


def _batch(step=0, **kw):
    return {k: torch.from_numpy(v) for k, v in _pipe(**kw).batch(step).items()}


def _grads(params, batch, policy=None, cfg=CFG):
    loss_fn = trainer_lib.make_loss_fn(
        cfg, policy or PrecisionPolicy.train_default())
    return trainer_lib.value_and_grad(loss_fn, params, batch)


def _assert_grads_close(got, want):
    """Each leaf within GRAD_BOUND of the leaf's max magnitude."""
    def check(g, w):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape
        err = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
        assert err < GRAD_BOUND, err
        return err

    return max(tree_lib.leaves(tree_lib.map_(check, got, want)))


def test_smoke_loss_and_gradients_match_jax(jax_params, np_params):
    batch = _pipe().batch(0)
    jloss_fn = jtrainer.make_loss_fn(jconfigs.SMOKE, JPolicy.train_default(),
                                     jtrainer.TrainerConfig())
    from repro.core import context as jcontext

    with jcontext.context(backend="ref"):
        (jl, _), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
            jax_params, {k: jnp.asarray(v) for k, v in batch.items()})
    (pl, _), pg = _grads(params_from_jax(np_params),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    jg_port = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    _assert_grads_close(pg, jg_port)


def test_smoke_trainer_steps_match_jax(jax_params, np_params):
    jt = jtrainer.Trainer(jconfigs.SMOKE, jtrainer.TrainerConfig(
        opt=jadamw.AdamWConfig(lr=1e-3), total_steps=30, warmup=2,
        matmul_backend="ref"))
    jpipe = JSyntheticLM(JDataConfig(vocab=CFG.vocab, seq_len=17,
                                     global_batch=4))
    jstate = jtrainer.TrainState(
        jax_params, jadamw.init(jax_params, jadamw.AdamWConfig()))
    _, jhist = jt.run(jpipe, num_steps=4, log_every=0, state=jstate)
    pt = trainer_lib.Trainer(CFG, trainer_lib.TrainerConfig(
        opt=adamw.AdamWConfig(lr=1e-3), total_steps=30, warmup=2),
        device="cpu")
    params = params_from_jax(np_params)
    pstate = trainer_lib.TrainState(params,
                                    adamw.init(params, adamw.AdamWConfig()))
    _, phist = pt.run(_pipe(), num_steps=4, log_every=0, state=pstate)
    assert len(phist) == len(jhist) == 4
    np.testing.assert_allclose(phist, jhist, rtol=GRAD_BOUND)


def _trainer(tmp_path, total=30, ckpt_every=5, **kw):
    tcfg = trainer_lib.TrainerConfig(
        opt=adamw.AdamWConfig(lr=1e-3), total_steps=total, warmup=2,
        ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=ckpt_every, keep=2, **kw)
    return trainer_lib.Trainer(CFG, tcfg, device="cpu")


def test_training_reduces_loss(tmp_path):
    state, history = _trainer(tmp_path).run(_pipe(), num_steps=30,
                                            log_every=0)
    assert len(history) == 30
    assert history[-1] < history[0]  # the synthetic bigram task is learnable
    assert all(np.isfinite(history))


def test_restart_resumes_from_checkpoint(tmp_path):
    _trainer(tmp_path).run(_pipe(), num_steps=12, log_every=0)
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 10
    assert ckpt.all_steps(str(tmp_path / "ckpt")) == [5, 10]  # keep=2
    # a crash: a brand-new trainer object, the same checkpoint directory
    _, hist = _trainer(tmp_path).run(_pipe(), num_steps=14, log_every=0)
    assert len(hist) == 4  # resumed at step 10


def test_nan_rollback_and_escalation(tmp_path):
    trainer = _trainer(tmp_path, total=20, ckpt_every=2)
    real_fn = trainer._step_fn
    calls = {"n": 0}

    def poisoned(state, batch):
        calls["n"] += 1
        new_state, metrics = real_fn(state, batch)
        if calls["n"] == 5:  # NaN params out of step 5
            bad = tree_lib.map_(lambda x: x * float("nan"), new_state.params)
            new_state = trainer_lib.TrainState(bad, new_state.opt)
            metrics = dict(metrics, params_finite=torch.zeros(()))
        return new_state, metrics

    trainer._step_fn = poisoned
    state, hist = trainer.run(_pipe(), num_steps=8, log_every=0)
    assert trainer.rollbacks >= 1
    assert len(hist) == 8 and all(np.isfinite(hist))
    assert trainer._escalated_fn is not None  # the full_fp32 step ran
    assert trainer.escalation_policy == PrecisionPolicy.full_fp32()
    assert all(torch.isfinite(x).all() for x in tree_lib.leaves(state.params))


def test_straggler_detection(tmp_path):
    trainer = _trainer(tmp_path)
    for _ in range(16):
        trainer._watch_straggler(0.01)
    trainer._watch_straggler(0.1)
    assert trainer.straggler_events == 1


def test_microbatch_accumulation_matches_full_batch():
    params = trainer_lib.Trainer(CFG, trainer_lib.TrainerConfig(),
                                 device="cpu").init_state().params
    batch = _batch()
    policy = PrecisionPolicy.full_fp32()
    loss_fn = trainer_lib.make_loss_fn(CFG, policy)
    (_, _), g_full = trainer_lib.value_and_grad(loss_fn, params, batch)
    g_micro, m = trainer_lib._accum_grads(loss_fn, params, batch, 2)
    assert _assert_grads_close(g_micro, tree_lib.map_(
        lambda g: g.numpy(), g_full)) < GRAD_BOUND
    assert torch.isfinite(m["loss"])


def test_remat_gives_the_bits_of_no_remat():
    params = trainer_lib.Trainer(CFG, trainer_lib.TrainerConfig(),
                                 device="cpu").init_state(seed=3).params
    batch = _batch(1)
    (l_on, _), g_on = _grads(params, batch)
    (l_off, _), g_off = _grads(params, batch, cfg=CFG.__class__(
        **{**CFG.__dict__, "remat": False}))
    assert CFG.remat
    assert torch.equal(l_on, l_off)
    for a, b in zip(tree_lib.leaves(g_on), tree_lib.leaves(g_off)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def step_launches(n_layers: int) -> dict:
    """Kernel calls of one train_default step with remat (the formula
    chip_smoke.py holds on the card): per layer the forward's QKV and
    SwiGLU projections, flash attention, wo and w_down, run twice (remat);
    the backward's dgrads (w_down 1, gate/up 2, wo 1, QKV 3) and the
    attention backward's 5 products per layer; lm_head forward and dgrad.
    Weight gradients are one plain product each (no kernel)."""
    return {"mp_fused_proj": 2 * 2 * n_layers,
            "mp_flash_attention": 2 * n_layers,
            "mp_fused_matmul": n_layers * (2 * 2 + 12) + 2}


def test_step_kernel_calls_are_the_formula():
    trainer = trainer_lib.Trainer(CFG, trainer_lib.TrainerConfig(),
                                  device="cpu")
    state = trainer.init_state()
    kernels.reset_launch_counts()
    trainer._step_fn(state, _batch())
    calls = {k: v for k, v in kernels.plain_call_counts().items() if v}
    assert calls == step_launches(CFG.n_layers)
    assert not any(kernels.launch_counts().values())


def test_embedding_backward_sums_each_row_in_token_order():
    """layers.sorted_row_sum, the embedding's backward: each id's rows
    added from +0.0 in token order (bitwise a loop over the tokens), ids
    never seen +0.0, a hot id hundreds of times among the tokens; and the
    gradient autograd takes through embed() is that sum."""
    rng = np.random.default_rng(23)
    V, D, T = 300, 8, 1024
    ids = np.concatenate([np.full(600, 7), rng.integers(0, 40, 300),
                          rng.integers(0, V, T - 900)])
    ids = torch.from_numpy(rng.permutation(ids))
    rows = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    want = torch.zeros(V, D)
    for t in range(T):
        want[ids[t]] = want[ids[t]] + rows[t]
    got = layers.sorted_row_sum(ids, rows, V)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    unseen = torch.ones(V, dtype=torch.bool)
    unseen[ids] = False
    assert unseen.any() and not got[unseen].any()
    table = torch.zeros(V, D, requires_grad=True)
    (layers.embed(ids.reshape(4, -1), table) * rows.reshape(4, -1, D)
     ).sum().backward()
    assert torch.equal(table.grad, want)


def test_backward_keeps_the_forward_context():
    """The forward's precision context holds for its backward and for the
    remat recompute, wherever the backward runs: forward on ``ref`` inside
    a scope, backward outside it, and no kernel wrapper is called."""
    params = trainer_lib.Trainer(CFG, trainer_lib.TrainerConfig(),
                                 device="cpu").init_state().params
    batch = _batch()
    loss_fn = trainer_lib.make_loss_fn(CFG, PrecisionPolicy.train_default())
    live = tree_lib.map_(lambda p: p.detach().requires_grad_(True), params)
    kernels.reset_launch_counts()
    with context_lib.context(backend="ref"):
        loss, _ = loss_fn(live, batch)
    loss.backward()
    assert not any(kernels.plain_call_counts().values())
    assert live["lm_head"]["w"].grad is not None
    # the ref backend is the trainer's matmul_backend option
    ref_tcfg = trainer_lib.TrainerConfig(matmul_backend="ref")
    kernels.reset_launch_counts()
    trainer_lib.make_train_step(CFG, PrecisionPolicy.train_default(),
                                ref_tcfg)(trainer_lib.TrainState(
                                    params, adamw.init(params, ref_tcfg.opt)),
                                    batch)
    assert not any(kernels.plain_call_counts().values())


def test_checkpoint_roundtrip_bf16_and_structure(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "m": [torch.tensor([1.5, -2.25]).bfloat16(),
                  torch.tensor(7, dtype=torch.int32)]}
    ckpt.save(d, 3, tree, extra_meta={"data_step": 3})
    like = tree_lib.map_(torch.zeros_like, tree)
    got, extra = ckpt.restore(d, 3, like)
    assert extra == {"data_step": 3}
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.load(open(f"{d}/step_{3:010d}/manifest.json"))
    assert manifest["leaves"]["m/0"]["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(d, 3, {"w": like["w"]})
    for s in (4, 5, 6):
        ckpt.save(d, s, tree, keep=2)
    assert ckpt.all_steps(d) == [5, 6] and ckpt.latest_step(d) == 6


def test_adamw_state_and_gradients_map_from_jax(jax_params, np_params):
    jstate = jadamw.init(jax_params, jadamw.AdamWConfig(
        moment_dtype="bfloat16"))
    jstate = jstate._replace(step=jnp.asarray(3, jnp.int32), m=jax.tree_util
                             .tree_map(lambda x: x + 1, jstate.m))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    state = adamw_state_from_jax(jstate.step, to_np(jstate.m),
                                 to_np(jstate.v))
    assert int(state.step) == 3 and state.step.dtype == torch.int32
    assert state.m["layers"][1]["mlp"]["w_up"].dtype == torch.bfloat16
    assert torch.equal(state.m["layers"][1]["mlp"]["w_up"].float(),
                       torch.ones(CFG.d_model, CFG.d_ff))
    params = params_from_jax(np_params)
    for a, b in zip(tree_lib.leaves(state.v), tree_lib.leaves(params)):
        assert a.shape == b.shape
    ours = adamw.init(params, adamw.AdamWConfig(moment_dtype="bfloat16"))
    assert [a.shape for a in tree_lib.leaves(ours.m)] == [
        a.shape for a in tree_lib.leaves(state.m)]


def test_param_count_matches_jax():
    for pc, jc in ((paper_mpfp.CONFIG, jconfigs.CONFIG),
                   (paper_mpfp.SMOKE, jconfigs.SMOKE)):
        assert pc.param_count() == jc.param_count()
        assert pc.active_param_count() == jc.active_param_count()
        assert pc.remat == jc.remat


def test_trainer_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        assert trainer_lib.Trainer(CFG, trainer_lib.TrainerConfig()) \
            .device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer_lib.Trainer(CFG, trainer_lib.TrainerConfig())


def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    state, hist = launch_train.main([
        "--smoke", "--steps", "3", "--batch", "2", "--seq", "8",
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    assert len(hist) == 3 and all(np.isfinite(hist))
    assert "done: loss" in capsys.readouterr().out
