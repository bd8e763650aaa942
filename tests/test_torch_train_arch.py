"""PyTorch port: training every model family against the JAX package.

One registry id per family — deepseek-v2-lite-16b (MoE + MLA), minicpm3-4b
(MLA dense), mamba2-130m (SSM), zamba2-2.7b (hybrid), llava-next-34b (VLM:
the patch positions sliced off the loss) and hubert-xlarge (audio: frame
embeddings in) — at SMOKE size, from ``params_from_jax`` of one JAX init
and one batch of each package's synthetic pipeline, under ``full_fp32``:
the JAX ``make_loss_fn`` on its ``ref`` backend, the port on CPU tensors
(its kernels' plain versions).

* the loss (the MoE aux and z-loss terms included) within 1e-5 relative,
  and its extras ``nll`` / ``moe_aux`` / ``moe_zloss``;
* every gradient leaf within 5e-4 of the leaf's max
  (``tests/test_torch_train.py``'s bound);
* remat on == remat off, bitwise, for each family; a router that picks
  other experts in the recompute raises;
* the pipeline's audio and vision batches bitwise the JAX package's;
* two ``Trainer.run`` steps of the MoE SMOKE against the JAX trainer, and
  ``launch/train.py --arch`` on it;
* every registry id's configuration, its dims dataclasses field by field,
  equal to the JAX package's; checkpoints and AdamW state of every
  family's tree."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import context as jcontext
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as moe_lib
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib
from repro_torch.weights import adamw_state_from_jax, params_from_jax

FAMILIES = {"moe": "deepseek-v2-lite-16b", "mla": "minicpm3-4b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
            "vlm": "llava-next-34b", "audio": "hubert-xlarge"}
ARCHS = list(FAMILIES.values())
MOE = FAMILIES["moe"]
LOSS_REL = 1e-5
GRAD_BOUND = 5e-4
B, SEQ = 2, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    return (jregistry.get_config(arch, smoke=True),
            registry.get_config(arch, smoke=True))


_PARAMS = {}


def _params(arch):
    """The JAX SMOKE params of ``arch`` (seed 0) and the port's copy."""
    if arch not in _PARAMS:
        jp = JT.init_params(_cfgs(arch)[0], jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, jax.tree_util.tree_map(np.asarray, jp))
    jp, npp = _PARAMS[arch]
    return jp, params_from_jax(npp)


def _data_cfg(cfg, cls, batch=B, seq=SEQ):
    return cls(vocab=cfg.vocab, seq_len=seq + 1, global_batch=batch,
               frontend=cfg.frontend, d_model=cfg.d_model,
               n_patches=cfg.n_patches)


def _batch(arch, step=0):
    """One batch of the port's pipeline: numpy, and as port tensors."""
    _, pcfg = _cfgs(arch)
    nb = SyntheticLM(_data_cfg(pcfg, DataConfig)).batch(step)
    return nb, {k: torch.from_numpy(v) for k, v in nb.items()}


def _assert_grads_close(got, want):
    worst = 0.0
    for (path, g), w in zip(tree_lib.items(got), tree_lib.leaves(want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, path
        err = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
        assert err < GRAD_BOUND, (path, err)
        worst = max(worst, err)
    return worst


def _jax_value_and_grad(arch, nb):
    jcfg, _ = _cfgs(arch)
    jp, _ = _params(arch)
    loss_fn = jtrainer.make_loss_fn(jcfg, JPolicy.full_fp32(),
                                    jtrainer.TrainerConfig())
    with jcontext.context(backend="ref"):
        (jl, jx), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
    return jl, jx, params_from_jax(jax.tree_util.tree_map(np.asarray, jg))


def _port_value_and_grad(arch, batch, cfg=None, policy=None):
    _, pcfg = _cfgs(arch)
    _, pp = _params(arch)
    loss_fn = trainer_lib.make_loss_fn(cfg or pcfg,
                                       policy or PrecisionPolicy.full_fp32(),
                                       trainer_lib.TrainerConfig())
    return trainer_lib.value_and_grad(loss_fn, pp, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_and_gradients_match_jax(arch):
    nb, batch = _batch(arch)
    jl, jx, jg = _jax_value_and_grad(arch, nb)
    (pl, px), pg = _port_value_and_grad(arch, batch)
    assert abs(float(pl) - float(jl)) <= LOSS_REL * abs(float(jl))
    for k in ("nll", "moe_aux", "moe_zloss"):
        np.testing.assert_allclose(float(px[k]), float(jx[k]),
                                   rtol=LOSS_REL, atol=1e-7)
    if arch == MOE:  # the aux terms reach the loss
        assert float(px["moe_aux"]) > 0 and float(px["moe_zloss"]) > 0
        assert float(pl) != float(px["nll"])
    _assert_grads_close(pg, jg)


@pytest.mark.parametrize("arch", ARCHS + ["deepseek-v2-236b"])
def test_remat_on_equals_off_bitwise(arch):
    """Each family's rematerialized layers (MoE layers with their aux
    values, Mamba2 layers, whole zamba2 groups) give the bits of the
    forward kept whole, under train_default."""
    _, batch = _batch(arch, step=1)
    _, pcfg = _cfgs(arch)
    pol = PrecisionPolicy.train_default()
    assert pcfg.remat
    (l_on, x_on), g_on = _port_value_and_grad(arch, batch, policy=pol)
    (l_off, x_off), g_off = _port_value_and_grad(
        arch, batch, cfg=dataclasses.replace(pcfg, remat=False), policy=pol)
    assert torch.equal(l_on, l_off)
    for k in x_on:
        assert torch.equal(x_on[k], x_off[k]), k
    for a, b in zip(tree_lib.leaves(g_on), tree_lib.leaves(g_off)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_a_router_that_reroutes_in_the_recompute_raises():
    log = moe_lib.RouteLog()
    picks = torch.tensor([[0, 1], [2, 3]])
    with log.recording():
        log.note(picks)
    with log.replaying():
        log.note(picks.clone())
    with pytest.raises(RuntimeError, match="other experts"):
        with log.replaying():
            log.note(torch.tensor([[0, 1], [3, 2]]))
    with pytest.raises(RuntimeError, match="routings"):
        with log.replaying():
            pass


def test_pinned_routing_takes_the_recorded_experts():
    """RouteLog.pinning: each router call takes the experts a recorded run
    picked, its gates this run's probabilities at them, and counts the
    tokens whose own top-k differs."""
    dims = moe_lib.MoEDims(d_model=8, n_experts=6, top_k=2, expert_ff=4)
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(10, 8, generator=g), torch.randn(8, 6, generator=g)
    pol = PrecisionPolicy.full_fp32()
    log = moe_lib.RouteLog()
    with log.recording():
        p0, i0, _ = moe_lib._route(x, w, dims, pol)
    x2 = x.flip(0)
    _, own, _ = moe_lib._route(x2, w, dims, pol)
    with log.pinning():
        p1, i1, aux = moe_lib._route(x2, w, dims, pol)
    assert torch.equal(i1, i0)
    probs = torch.softmax(x2 @ w, dim=-1).gather(-1, i0)
    torch.testing.assert_close(p1, probs / probs.sum(-1, keepdim=True))
    assert log.flips == [int((own.sort(-1)[0] != i0.sort(-1)[0])
                             .any(-1).sum())] and log.flips[0] > 0
    assert torch.isfinite(aux["moe_aux"])


def test_scan_group_remats_groups_with_the_same_bits():
    """``scan_group`` (JAX's nested scan) makes one rematerialized region
    of g layers; the bits are those of per-layer remat."""
    arch = FAMILIES["mla"]
    _, batch = _batch(arch, step=2)
    _, pcfg = _cfgs(arch)
    deep = dataclasses.replace(pcfg, n_layers=4)
    from repro_torch.models import transformer as PT

    params = PT.init_params(deep, seed=1)
    fn = trainer_lib.make_loss_fn
    pol = PrecisionPolicy.train_default()
    outs = [trainer_lib.value_and_grad(
        fn(dataclasses.replace(deep, scan_group=g), pol), params, batch)
        for g in (1, 2)]
    (l1, _), g1 = outs[0]
    (l2, _), g2 = outs[1]
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(g1),
                                                  tree_lib.leaves(g2)))


@pytest.mark.parametrize("frontend", ["audio", "vision"])
def test_synthetic_frontend_batches_are_jax_bitwise(frontend):
    arch = FAMILIES["audio" if frontend == "audio" else "vlm"]
    jcfg, pcfg = _cfgs(arch)
    assert pcfg.frontend == frontend
    for step, rank, world in ((0, 0, 1), (3, 1, 2)):
        got = SyntheticLM(_data_cfg(pcfg, DataConfig, batch=4)).batch(
            step, rank, world)
        want = JSyntheticLM(_data_cfg(jcfg, JDataConfig, batch=4)).batch(
            step, rank, world)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_moe_trainer_steps_match_jax():
    """Two Trainer.run steps of the MoE SMOKE (AdamW, aux and z-loss in
    the loss) from the same params and batches: losses within 5e-4."""
    jcfg, pcfg = _cfgs(MOE)
    jp, pp = _params(MOE)
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(
        opt=jadamw.AdamWConfig(lr=1e-3), total_steps=30, warmup=2,
        matmul_backend="ref"), policy=JPolicy.full_fp32())
    jstate = jtrainer.TrainState(jp, jadamw.init(jp, jadamw.AdamWConfig()))
    _, jhist = jt.run(JSyntheticLM(_data_cfg(jcfg, JDataConfig)),
                      num_steps=2, log_every=0, state=jstate)
    pt = trainer_lib.Trainer(pcfg, trainer_lib.TrainerConfig(
        opt=adamw.AdamWConfig(lr=1e-3), total_steps=30, warmup=2),
        policy=PrecisionPolicy.full_fp32(), device="cpu")
    pstate = trainer_lib.TrainState(pp, adamw.init(pp, adamw.AdamWConfig()))
    _, phist = pt.run(SyntheticLM(_data_cfg(pcfg, DataConfig)), num_steps=2,
                      log_every=0, state=pstate)
    assert len(phist) == len(jhist) == 2
    np.testing.assert_allclose(phist, jhist, rtol=GRAD_BOUND)


def test_microbatches_report_zero_aux_as_jax():
    """_accum_grads: the mean of the microbatches' losses (aux included)
    as loss and nll, zero aux in the metrics — JAX's report, held on a
    small quadratic loss in both packages — and on the MoE SMOKE the
    port's loss is the mean of its microbatches' own losses."""
    w = np.arange(6, dtype=np.float32).reshape(3, 2) / 7
    xb = np.linspace(-1, 1, 12, dtype=np.float32).reshape(4, 3)

    def jloss(p, b):
        return jnp.sum((b["x"] @ p["w"]) ** 2), {}

    def ploss(p, b):
        return torch.sum((b["x"] @ p["w"]) ** 2), {}

    _, jm = jtrainer._accum_grads(jloss, {"w": jnp.asarray(w)},
                                  {"x": jnp.asarray(xb)}, 2)
    _, pm = trainer_lib._accum_grads(ploss, {"w": torch.from_numpy(w)},
                                     {"x": torch.from_numpy(xb)}, 2)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6)
    _, batch = _batch(MOE)
    _, pcfg = _cfgs(MOE)
    _, pp = _params(MOE)
    loss_fn = trainer_lib.make_loss_fn(pcfg, PrecisionPolicy.full_fp32())
    _, m = trainer_lib._accum_grads(loss_fn, pp, batch, 1)
    rows = [trainer_lib.value_and_grad(
        loss_fn, pp, {k: v[i:i + 1] for k, v in batch.items()})[0][0]
        for i in range(B)]
    assert torch.equal(m["loss"], (rows[0] + rows[1]) / 2)
    assert torch.equal(m["nll"], m["loss"])
    assert float(m["moe_aux"]) == 0.0 and float(m["moe_zloss"]) == 0.0


def test_train_launcher_takes_a_registry_arch(tmp_path, capsys):
    _, hist = launch_train.main([
        "--arch", MOE, "--smoke", "--steps", "2", "--batch", "2", "--seq",
        "8", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert "done: loss" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--smoke"):
        launch_train.main(["--arch", MOE, "--device", "cpu"])


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_configs_and_dims_equal_jax_field_by_field(arch):
    for smoke in (False, True):
        jcfg = jregistry.get_config(arch, smoke=smoke)
        pcfg = registry.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        for name in ("moe", "mla", "ssm"):
            jd, pd = getattr(jcfg, name), getattr(pcfg, name)
            assert (jd is None) == (pd is None), name
            if jd is not None:
                assert [f.name for f in dataclasses.fields(pd)] == \
                    [f.name for f in dataclasses.fields(jd)], name
                assert dataclasses.astuple(pd) == dataclasses.astuple(jd)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_and_adamw_state_of_every_family(arch, tmp_path):
    """Every family's tree (stacked experts, SSM, the shared block and its
    LoRA) saves and restores bitwise, and a JAX AdamW state of it maps
    leaf for leaf onto the port's params."""
    jp, pp = _params(arch)
    jst = jadamw.init(jp, jadamw.AdamWConfig())
    st = adamw_state_from_jax(jst.step, jax.tree_util.tree_map(
        np.asarray, jst.m), jax.tree_util.tree_map(np.asarray, jst.v))
    shapes = [tuple(x.shape) for x in tree_lib.leaves(pp)]
    assert [tuple(x.shape) for x in tree_lib.leaves(st.m)] == shapes
    assert [tuple(x.shape) for x in tree_lib.leaves(st.v)] == shapes
    state = trainer_lib.TrainState(pp, st)
    ckpt.save(str(tmp_path), 1, state)
    like = tree_lib.map_(torch.zeros_like, state)
    got, _ = ckpt.restore(str(tmp_path), 1, like)
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
