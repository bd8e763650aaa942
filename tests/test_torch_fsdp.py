"""PyTorch port: the FSDP layout of the training step (``dist/fsdp.py``,
``Trainer(layout=specs.fsdp_layout(...))``) against the JAX package's
``make_rules`` / ``param_shardings`` layout and against the port's
one-rank step.

The port runs in 4 gloo ranks (tests/torch_dist_pool.py) on a (data 2,
model 2) mesh; the rules are ``launch/specs.make_rules``' for a train cell
of 4 rows, so the batch and every leaf's trailing dim lay out over both
axes.  JAX runs on a (2, 2) mesh of 4 of its 8 fake CPU devices.

* **Blocks are JAX's.**  Every leaf of the train state, numbered, and the
  batch's rows: each rank's block equals the block JAX's
  ``devices_indices_map`` gives the device at the same mesh coordinates
  (every non-MoE family; ``d_ff`` 66 leaves ``w_gate`` / ``w_up``
  replicated).
* **The step is JAX's.**  paper-mpfp-100m SMOKE: JAX's train step executed
  under ``use_rules(make_rules(...))`` with the state ``device_put`` to its
  shardings; the port's 4-rank step, gathered: the loss within 1e-5
  relative, every leaf of the new params and moments within 5e-4 of the
  leaf's max (tests/test_torch_train.py's bounds), three ``Trainer.run``
  steps' losses within 5e-4 relative.
* **The step is the port's one-rank step.**  Each family: each row's
  logits bitwise the one-rank rows, the loss and every gradient leaf
  within the bounds above, replicated leaves and metrics bitwise equal on
  every rank, the collectives of the formula (a one-rank step calls
  none), each rank's state bytes the layout's arithmetic.
* Checkpoints cross between 4 ranks and one bitwise; a NaN in one rank's
  block rolls every rank back; the MoE family refuses the layout.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jregistry
from repro.configs.shapes import ShapeCell as JShapeCell
from repro.core import context as jcontext
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeCell
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist import fsdp
from repro_torch.dist import sharding as sh_lib
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib
from repro_torch.weights import adamw_state_from_jax, params_from_jax
from torch_dist_pool import RankPool

WORLD = 4
B, S = 4, 16
GRAD_BOUND = 5e-4
LR = 1e-3
# one SMOKE config of every non-MoE family; d_ff 66 does not divide the
# batch group's 4 ranks, so w_gate / w_up stay replicated
FAMILIES = {
    "paper-mpfp-100m": ("paper-mpfp-100m", None),
    "paper-mpfp-100m-ff66": ("paper-mpfp-100m", {"d_ff": 66}),
    "minicpm3-4b": ("minicpm3-4b", None),
    "mamba2-130m": ("mamba2-130m", None),
    "zamba2-2.7b": ("zamba2-2.7b", None),
    "llava-next-34b": ("llava-next-34b", None),
    "hubert-xlarge": ("hubert-xlarge", None),
}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.close()


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 fake devices")
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


def _jcfg(name):
    arch, overrides = FAMILIES[name]
    return dataclasses.replace(jregistry.get_config(arch, smoke=True),
                               **(overrides or {}))


def _cfg(name):
    arch, overrides = FAMILIES[name]
    return dataclasses.replace(registry.get_config(arch, smoke=True),
                               **(overrides or {}))


def _jrules(jmesh, jcfg):
    return jspecs.make_rules(jmesh, JShapeCell("smoke", S, B, "train"), jcfg)


def _batch(cfg, step=0):
    """The port pipeline's global batch (numpy, seeded)."""
    return SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=S + 1, global_batch=B,
        frontend=cfg.frontend, d_model=cfg.d_model,
        n_patches=cfg.n_patches)).batch(step)


@pytest.fixture(scope="module")
def jax_params():
    cache = {}

    def get(name):
        if name not in cache:
            p = JT.init_params(_jcfg(name), jax.random.PRNGKey(0))
            cache[name] = jax.tree_util.tree_map(np.asarray, p)
        return cache[name]

    return get


def _rel(a, b):
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


class Batches:
    """A pipeline of fixed global batches."""

    def __init__(self, batches):
        self.batches = batches

    def batch(self, step):
        return self.batches[step]


def _to_port_state(params, step, m, v):
    return trainer_lib.TrainState(params_from_jax(params),
                                  adamw_state_from_jax(step, m, v))


# ---------------------------------------------------------------- blocks
@pytest.fixture(scope="module")
def blocks(pool, jmesh):
    """Every family's numbered train state and batch, each rank's blocks,
    and JAX's blocks of the same numbers for the device at each rank's
    coordinates."""
    runs, want = {}, {}
    for name in FAMILIES:
        jcfg = _jcfg(name)
        rules = _jrules(jmesh, jcfg)
        st, _ = jspecs.state_structs(jcfg, rules, "float32")
        flat, tdef = jax.tree_util.tree_flatten(st)
        nums = [np.arange(s.size, dtype=np.int64).reshape(s.shape)
                for s in flat]
        tree = jax.tree_util.tree_unflatten(tdef, nums)
        batch = {k: np.arange(np.prod(v.shape), dtype=np.int64).reshape(
            v.shape) for k, v in _batch(_cfg(name)).items()}
        port = _to_port_state(tree.params, tree.opt.step, tree.opt.m,
                              tree.opt.v)
        runs[name] = (*FAMILIES[name],
                      tree_lib.map_(lambda t: t.numpy(), port), batch)
        bsh = NamedSharding(jmesh, P(rules.batch, None))
        per_dev = {}
        for d in range(2):
            for m in range(2):
                dev = jmesh.devices[d, m]
                jb = jax.tree_util.tree_unflatten(tdef, [
                    x[s.sharding.devices_indices_map(s.shape)[dev]]
                    for x, s in zip(nums, flat)])
                rows = bsh.devices_indices_map((B, S))[dev][0]
                per_dev[(d, m)] = (
                    {p: x.numpy() for p, x in tree_lib.items(_to_port_state(
                        jb.params, jb.opt.step, jb.opt.m, jb.opt.v))},
                    {k: v[rows] for k, v in batch.items()})
        want[name] = per_dev
    return pool.run("fsdp_blocks", runs), want


@pytest.mark.parametrize("name", list(FAMILIES))
def test_each_ranks_blocks_and_rows_are_jax(blocks, name):
    res, want = blocks
    for r in res:
        got_state, got_batch = r[name]
        w_state, w_batch = want[name][r["coord"]]
        assert sorted(got_state) == sorted(w_state)
        for p, x in w_state.items():
            np.testing.assert_array_equal(got_state[p], x, err_msg=p)
        assert sorted(got_batch) == sorted(w_batch)
        for k, x in w_batch.items():
            assert x.shape[0] == B // WORLD
            np.testing.assert_array_equal(got_batch[k], x)
    assert sorted(r["coord"] for r in res) == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]


# ---------------------------------------------------------------- vs JAX
@pytest.fixture(scope="module")
def jax_steps(pool, jmesh, jax_params):
    name = "paper-mpfp-100m"
    jcfg, np_params = _jcfg(name), jax_params(name)
    pipe = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq_len=S + 1,
                                    global_batch=B))
    batches = [pipe.batch(i) for i in range(3)]
    res = pool.run("fsdp_jax_steps", np_params, batches)
    rules = _jrules(jmesh, jcfg)
    st, _ = jspecs.state_structs(jcfg, rules, "float32")
    shardings = jax.tree_util.tree_map(lambda s: s.sharding, st)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    state = jax.device_put(jtrainer.TrainState(params, jadamw.init(
        params, jadamw.AdamWConfig(lr=LR))), shardings)
    step = jtrainer.make_train_step(
        jcfg, JPolicy.train_default(), jtrainer.TrainerConfig(
            opt=jadamw.AdamWConfig(lr=LR), total_steps=30, warmup=2))

    def fn(state, batch):
        with jsh.use_rules(rules):
            return step(state, batch)

    bsh = NamedSharding(jmesh, P(rules.batch, None))
    losses = []
    with jmesh, jcontext.context(backend="ref"):
        f = jax.jit(fn)
        s = state
        for b in batches:
            s, m = f(s, {k: jax.device_put(jnp.asarray(v), bsh)
                         for k, v in b.items()})
            losses.append(float(m["loss"]))
            if len(losses) == 1:
                first = jax.tree_util.tree_map(np.asarray, s)
    return res, losses, first


def test_the_step_is_jax_under_make_rules(jax_steps):
    res, losses, first = jax_steps
    for r in res[1:]:
        assert r["loss"] == res[0]["loss"]
        for p, x in r["new"].items():
            np.testing.assert_array_equal(x, res[0]["new"][p])
    r = res[0]
    assert abs(r["loss"] - losses[0]) <= 1e-5 * abs(losses[0])
    want = {p: x.numpy() for p, x in tree_lib.items(_to_port_state(
        first.params, first.opt.step, first.opt.m, first.opt.v))}
    assert sorted(r["new"]) == sorted(want)
    for p, w in want.items():
        assert r["new"][p].shape == w.shape, p
        if p == "1/0":
            assert int(r["new"][p]) == int(w) == 1
            continue
        assert _rel(r["new"][p], w) < GRAD_BOUND, p


def test_three_trainer_steps_are_jax(jax_steps):
    res, losses, _ = jax_steps
    for r in res:
        assert r["history"] == res[0]["history"]
    np.testing.assert_allclose(res[0]["history"], losses, rtol=GRAD_BOUND)


# ---------------------------------------------------------------- vs one rank
@pytest.fixture(scope="module")
def one_rank(pool, jax_params):
    cache = {}

    def get(name):
        if name not in cache:
            arch, overrides = FAMILIES[name]
            cache[name] = pool.run("fsdp_vs_one_rank", arch, overrides,
                                   jax_params(name), _batch(_cfg(name)))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(FAMILIES))
def test_row_logits_are_the_one_rank_rows_bitwise(one_rank, name):
    res = one_rank(name)
    seen = []
    for r in res:
        assert r["logits"].shape[0] == B // WORLD
        np.testing.assert_array_equal(r["logits"],
                                      r["one_logits"][r["rows"]])
        seen += list(r["rows"])
    assert sorted(seen) == list(range(B))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_and_gradients_are_the_one_rank_step(one_rank, name):
    r = one_rank(name)[0]
    loss, one = float(r["metrics"]["loss"]), float(r["one_metrics"]["loss"])
    assert abs(loss - one) <= 1e-5 * abs(one)
    assert sorted(r["grads"]) == sorted(r["one_grads"])
    for p, g in r["one_grads"].items():
        assert r["grads"][p].shape == g.shape, p
        assert _rel(r["grads"][p], g) < GRAD_BOUND, p
    for p, w in r["one_new"].items():
        if w.dtype.kind == "f":
            assert _rel(r["new"][p], w) < GRAD_BOUND, p
        else:
            np.testing.assert_array_equal(r["new"][p], w)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_replicated_leaves_and_metrics_are_equal_on_every_rank(one_rank,
                                                               name):
    res = one_rank(name)
    r0 = res[0]
    for r in res[1:]:
        for k, v in r0["metrics"].items():
            np.testing.assert_array_equal(r["metrics"][k], v, err_msg=k)
        assert sorted(r["replicated"]) == sorted(r0["replicated"])
        for p, x in r0["replicated"].items():
            np.testing.assert_array_equal(r["replicated"][p], x, err_msg=p)
    n_rep = sum(not s for s in r0["sharded"].values())
    # the AdamW step always; w_gate / w_up of every layer at d_ff 66
    assert len(r0["replicated"]) == 1 + 3 * n_rep
    if name.endswith("ff66"):
        assert n_rep == 2 * _cfg(name).n_layers
    assert float(r0["metrics"]["params_finite"]) == 1.0


def _remat_leaf(path: str) -> bool:
    """A leaf the forward gathers inside a rematerialized region: the
    layers', and the hybrid's per-group LoRA (its shared block is gathered
    once, outside the groups)."""
    return path.split("/")[0] in ("layers", "shared_lora")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_collectives_are_the_formula(one_rank, name):
    """Per step: all_gather one per sharded leaf and again per sharded
    layer leaf in remat's recompute (a rank hands in its block),
    reduce_scatter one per sharded leaf (the whole cotangent), all_reduce
    one per replicated leaf (its gradient), the clipping norm and the
    metrics (loss, nll, params_finite: 3 floats); the one-rank step calls
    none."""
    cfg = _cfg(name)
    assert cfg.remat
    full = dict(tree_lib.items(T.init_params(cfg, device="meta")))
    r = one_rank(name)[0]
    sh = r["sharded"]
    nb = {p: x.numel() * x.element_size() for p, x in full.items()}
    gathered = [p for p in full if sh[p]]
    again = [p for p in gathered if _remat_leaf(p)]
    reps = [p for p in full if not sh[p]]
    want = {
        "all_gather": {"calls": len(gathered) + len(again),
                       "bytes": sum(nb[p] // WORLD for p in gathered + again)},
        "reduce_scatter": {"calls": len(gathered),
                           "bytes": sum(nb[p] for p in gathered)},
        "all_reduce": {"calls": len(reps) + 2,
                       "bytes": sum(nb[p] for p in reps) + 4 + 3 * 4}}
    for k, w in want.items():
        got = r["counts"][k]
        assert (got["calls"], got["bytes"]) == (w["calls"], w["bytes"]), k
        assert got["staged"] == 0
    assert not any(c["calls"] for c in r["one_counts"].values())
    # the rank's state: the blocks' bytes, 1/4 of each sharded leaf
    want_bytes = 3 * sum(nb[p] // WORLD if sh[p] else nb[p] for p in full)
    assert r["local_bytes"] == want_bytes + 4      # + the 0-d int32 step


# ---------------------------------------------------------------- the loop
def test_checkpoints_cross_between_four_ranks_and_one(pool, jax_params,
                                                      tmp_path):
    """A 4-rank checkpoint (the global arrays, written by rank 0)
    restores on one rank bitwise to the gathered state; a one-rank
    checkpoint restores onto the 4 ranks as their blocks, bitwise."""
    name = "paper-mpfp-100m"
    cfg, np_params = _cfg(name), jax_params(name)
    batches = [_batch(cfg, i) for i in range(2)]
    ck4, ck1 = tmp_path / "ck4", tmp_path / "ck1"
    one = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(
        opt=adamw.AdamWConfig(lr=LR), total_steps=30, warmup=2,
        ckpt_dir=str(ck1), ckpt_every=1), device="cpu")
    params = params_from_jax(np_params)
    one_state, _ = one.run(Batches(batches), num_steps=1, log_every=0,
                           state=trainer_lib.TrainState(
                               params, adamw.init(params, one.tcfg.opt)))
    res = pool.run("fsdp_checkpoints", np_params, batches, str(ck4),
                   str(ck1))
    assert ckpt.all_steps(str(ck4)) == [2]
    like = one.init_state()
    got, extra = ckpt.restore(str(ck4), 2, like)
    assert extra == {"data_step": 2}
    for p, x in tree_lib.items(got):
        for r in res:
            np.testing.assert_array_equal(x.numpy(), r["gathered"][p],
                                          err_msg=p)
    full = {p: x.numpy() for p, x in tree_lib.items(one_state)}
    for r in res:
        assert r["data_step"] == 1
        idx = 2 * r["coord"][0] + r["coord"][1]
        for p, x in full.items():
            if x.ndim and x.shape[-1] % WORLD == 0:
                w = x.shape[-1] // WORLD
                x = x[..., idx * w:(idx + 1) * w]
            np.testing.assert_array_equal(r["restored"][p], x, err_msg=p)


def test_a_nan_in_one_ranks_block_rolls_every_rank_back(pool, jax_params,
                                                        tmp_path):
    """test_torch_train.py::test_nan_rollback_and_escalation under the
    layout: rank 0's NaN block reaches every rank's params_finite (one
    all-reduce), so all ranks roll back, escalate and finish the same 8
    finite steps."""
    name = "paper-mpfp-100m"
    cfg = _cfg(name)
    batches = [_batch(cfg, i) for i in range(8)]
    res = pool.run("fsdp_nan_rollback", jax_params(name), batches,
                   str(tmp_path / "ck"))
    for r in res:
        assert r["rollbacks"] == 1 and r["escalated"] and r["finite"]
        assert len(r["history"]) == 8 and all(np.isfinite(r["history"]))
        assert r["history"] == res[0]["history"]
        # the poisoned fifth step: a finite loss, no finite params
        assert r["step_finite"][4] == 0.0 and np.isfinite(r["step_loss"][4])
        assert r["step_finite"] == res[0]["step_finite"]


def test_the_moe_family_refuses_the_layout():
    """Under an installed layout an MoE forward raises (its router
    statistics would need a global reduction), before any collective."""
    cfg = registry.get_config("deepseek-v2-lite-16b", smoke=True)
    params = T.init_params(cfg, device="meta")
    tokens = torch.zeros((1, 4), dtype=torch.int64, device="meta")
    with fsdp.use_layout(fsdp.Layout(rules=None, params=None)):
        with pytest.raises(NotImplementedError, match="router statistics"):
            T.forward(params, {"tokens": tokens}, cfg,
                      PrecisionPolicy.train_default())


# ---------------------------------------------------------------- no ranks
class CoordMesh:
    """What the layout reads of a ``DeviceMesh`` at one rank's
    coordinates: its axis names, sizes and the coordinates."""

    def __init__(self, sizes, coord):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self._coord = list(coord)

    def size(self, i):
        return self.shape[i]

    def get_coordinate(self):
        return self._coord


@pytest.mark.parametrize("arch,rows,phase,force,model,ported", [
    ("paper-mpfp-100m", B, "train", "", 2, True),
    ("hubert-xlarge", B, "train", "", 2, True),
    ("deepseek-v2-lite-16b", B, "train", "", 2, False),   # MoE
    ("paper-mpfp-100m", B, "prefill", "", 2, False),
    ("paper-mpfp-100m", 2, "train", "", 2, False),       # sequence over model
    ("paper-mpfp-100m", B, "train", "tp", 2, False),     # Megatron TP
    ("paper-mpfp-100m", 3, "train", "", 1, False),       # batch on 1 rank
])
def test_fsdp_layout_is_decided_by_make_rules(arch, rows, phase, force,
                                              model, ported, monkeypatch):
    """``specs.fsdp_layout``, the one decision the dry run, the launcher
    and the trainer's callers share: a train cell under pure FSDP rules
    over more than one rank, of a family without MoE layers, else the
    whole-rank run (3 rows on (data 2, model 1): the batch goes to the
    model axis, one rank)."""
    monkeypatch.setenv("REPRO_FORCE_LAYOUT", force)
    cfg = registry.get_config(arch, smoke=True)
    mesh = CoordMesh({"data": 2, "model": model}, (0, 0))
    cell = ShapeCell("smoke", S, rows, phase)
    rules = specs.make_rules(mesh, cell, cfg)
    layout = specs.fsdp_layout(cfg, cell, rules)
    assert (layout is not None) == ported
    if ported:
        assert layout.rules is rules and layout.size == 2 * model
        assert rules.batch_axes == ("data", "model")
        tcfg = trainer_lib.TrainerConfig(matmul_backend="sharded")
        with pytest.raises(ValueError, match="K-shard"):
            trainer_lib.Trainer(cfg, tcfg, device="cpu", layout=layout)


def test_a_checkpoint_is_read_a_leaf_at_a_time_mapped(tmp_path):
    """The streamed ``.npz`` is ``np.savez``'s format; each stored leaf is
    read mapped from the file, and a layout's restore copies this rank's
    block of it (JAX's block at the rank's mesh coordinates)."""
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((3, 8), np.float32)),
            "h": torch.from_numpy(rng.standard_normal((4, 8), np.float32)
                                  ).to(torch.bfloat16),
            "odd": torch.arange(6, dtype=torch.float32),
            "empty": torch.zeros((0, 4)),
            "step": torch.tensor(7, dtype=torch.int32)}
    path = ckpt.save(str(tmp_path), 1, tree)
    npz = f"{path}/shard_host0.npz"
    read = ckpt._reader(npz)
    with open(f"{path}/manifest.json") as f:
        keys = {p: m["key"] for p, m in json.load(f)["leaves"].items()}
    with np.load(npz) as data:
        for p, k in keys.items():
            np.testing.assert_array_equal(read(k), data[k], err_msg=p)
            assert isinstance(read(k), np.memmap) == (p != "empty"), p
    got, _ = ckpt.restore(str(tmp_path), 1, tree)
    for p, x in tree_lib.items(tree):
        assert torch.equal(got[p], x) and got[p].dtype == x.dtype, p
    # rank (1, 0) of a (data 2, model 2) mesh: block 2 of 4 along the
    # trailing dim where it divides 4, else the whole leaf
    mesh = CoordMesh({"data": 2, "model": 2}, (1, 0))
    spec = lambda x: sh_lib.Sharding(  # noqa: E731
        mesh, (None,) * (x.ndim - 1) + (("data", "model"),) if x.ndim
        else ())
    shardings = tree_lib.map_(spec, tree)
    like = tree_lib.map_(lambda x, s: sh_lib.shard(x, s), tree, shardings)
    got, _ = ckpt.restore(str(tmp_path), 1, like, shardings=shardings,
                          local=True)
    assert torch.equal(got["w"], tree["w"][:, 4:6])
    assert torch.equal(got["h"], tree["h"][:, 4:6])
    assert torch.equal(got["odd"], tree["odd"])
    assert got["empty"].shape == (0, 1) and torch.equal(got["step"],
                                                        tree["step"])
