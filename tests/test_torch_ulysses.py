"""PyTorch port: the Ulysses layout of the train and prefill steps
(``dist/seq_layout.py``, ``Trainer(layout=specs.seq_layout(...))``,
``make_prefill_step(layout=...)``) against the JAX package's
``make_rules`` layout and against the port's one-rank steps.

The port runs in 4 gloo ranks (tests/torch_dist_pool.py) on a (data 2,
model 2) mesh; a cell of 2 rows of 32 positions takes JAX's small-batch
rules: the batch over ``data``, the sequence over ``model`` (blocks of 16).
JAX runs on a (2, 2) mesh of 4 of its 8 fake CPU devices.

* **Blocks are JAX's.**  A train and a prefill cell of every non-MoE
  family, numbered: each rank's block of every train-state leaf or
  parameter, its rows of the batch (the whole sequence) and its prefill
  cache blocks equal the blocks JAX's ``devices_indices_map`` gives the
  device at the same mesh coordinates.  The SSM states are the stated
  exception (``ROADMAP.md`` Queue 3, as in tests/test_torch_decode_layout
  .py): the port lays them out by rows.
* **The step is JAX's.**  JAX's train and prefill steps under
  ``use_rules(make_rules(...))`` against the port's 4-rank steps from the
  same weights: heads mode (paper-mpfp-100m SMOKE, 4 heads over 2) and seq
  mode (the same config at 3 heads of 16, which the model axis does not
  divide): the loss within 1e-5, every new state leaf within 5e-4 of its
  max (tests/test_torch_fsdp.py's bounds), the prefill's last logits and
  cache within serve_default's M8 bound.
* **The step is the one-rank step.**  Dense in both modes and on both
  attention routes (flash at these sizes, the chunk-scan with the route's
  threshold at 0), GQA, MLA in both modes, the VLM with its 20 patches
  across the block boundary, the SSM, the hybrid and audio (not causal):
  the forward's logits on every rank's rows and block and the prefill's
  last logits and gathered cache bitwise the one-rank step's, the loss
  within 1e-5 and every gradient leaf within 5e-4 of its max, the
  collectives of a train step and of a prefill of the formula, the plain
  calls of the one-rank formula at the rank's rows and block, the
  resident bytes the layout's arithmetic.
* Edges: an SSM block off its chunk raises; a prefill into a longer cache
  raises; the MoE family refuses the layout naming item 2d;
  ``specs.seq_layout``'s decision.
"""
import dataclasses

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
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeCell
from repro_torch.core.formats import resolve
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import fsdp
from repro_torch.dist import seq_layout as sl
from repro_torch.dist.sharding import AxisRules
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from repro_torch.weights import (adamw_state_from_jax, cache_from_jax,
                                 params_from_jax)
from torch_dist_cases import cache_items, ulysses_inputs
from torch_dist_pool import RankPool

WORLD = 4
B, S = 2, 32
M = 2                      # the model axis: blocks of S / M positions
GRAD_BOUND = 5e-4
LR = 1e-3
M8 = resolve("M8").rel_err_bound
SEQ_HEADS = {"n_heads": 3, "n_kv_heads": 3, "head_dim": 16}
FAMILIES = ("paper-mpfp-100m", "chatglm3-6b", "minicpm3-4b",
            "llava-next-34b", "mamba2-130m", "zamba2-2.7b", "hubert-xlarge")


def _mla_seq(cfg):
    """minicpm3-4b SMOKE at 3 heads: MLA in seq mode."""
    return {"n_heads": 3, "mla": dataclasses.replace(cfg.mla, n_heads=3)}


# the one-rank runs: name -> (arch, overrides, the route's threshold)
RUNS = {
    "dense-heads": ("paper-mpfp-100m", None, None),
    "dense-heads-chunk": ("paper-mpfp-100m", None, 0),
    "dense-seq": ("paper-mpfp-100m", SEQ_HEADS, None),
    "dense-seq-chunk": ("paper-mpfp-100m", SEQ_HEADS, 0),
    "gqa-chunk": ("chatglm3-6b", None, 0),
    "mla-heads": ("minicpm3-4b", None, None),
    "mla-seq-chunk": ("minicpm3-4b", "mla-seq", 0),
    "vlm": ("llava-next-34b", {"n_patches": 20}, None),
    "ssm": ("mamba2-130m", None, None),
    "hybrid-chunk": ("zamba2-2.7b", None, 0),
    "audio": ("hubert-xlarge", None, None),
}


def _overrides(name):
    arch, ov, _ = RUNS[name]
    if ov == "mla-seq":
        return _mla_seq(registry.get_config(arch, smoke=True))
    return ov


def _cfg(name):
    arch = RUNS[name][0]
    return dataclasses.replace(registry.get_config(arch, smoke=True),
                               **(_overrides(name) or {}))


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


def _jcell(phase):
    return JShapeCell("smoke", S, B, phase)


def _numbered(structs):
    flat, tdef = jax.tree_util.tree_flatten(structs)
    nums = [np.arange(s.size, dtype=np.float32).reshape(s.shape)
            if s.ndim else np.zeros((), np.int32) for s in flat]
    return flat, tdef, nums


def _to_port_state(params, step, m, v):
    from repro_torch.train import trainer as trainer_lib

    return trainer_lib.TrainState(params_from_jax(params),
                                  adamw_state_from_jax(step, m, v))


# ---------------------------------------------------------------- blocks
@pytest.fixture(scope="module")
def blocks(pool, jmesh):
    """Every family's numbered train state / parameters, batch and prefill
    cache, each rank's blocks, and JAX's blocks of the same numbers for
    the device at each rank's coordinates."""
    runs, want = {}, {}
    for arch in FAMILIES:
        jcfg = jregistry.get_config(arch, smoke=True)
        cfg = registry.get_config(arch, smoke=True)
        for phase in ("train", "prefill"):
            rules = jspecs.make_rules(jmesh, _jcell(phase), jcfg)
            assert (rules.batch, rules.seq_axes) == ("data", ("model",))
            if phase == "train":
                st, _ = jspecs.state_structs(jcfg, rules, "float32")
            else:
                st = jspecs.params_structs(jcfg, rules)
            flat, tdef, nums = _numbered(st)
            tree = jax.tree_util.tree_unflatten(tdef, nums)

            def port(t):
                return (_to_port_state(t.params, t.opt.step, t.opt.m,
                                       t.opt.v) if phase == "train"
                        else params_from_jax(t))

            batch = {k: np.arange(v.size, dtype=np.int64).reshape(v.shape)
                     for k, v in ulysses_inputs(cfg, B, S).items()}
            if phase == "prefill":
                batch.pop("labels")
            cache = cflat = ctdef = cnums = None
            if phase == "prefill" and not cfg.encoder_only:
                cst = jspecs.cache_structs(jcfg, _jcell(phase), rules)
                cflat, ctdef, cnums = _numbered(cst)
                cache = cache_from_jax(jax.tree_util.tree_unflatten(
                    ctdef, cnums))
            runs[(arch, phase)] = (arch, None, phase, B, S, tree_lib.map_(
                lambda t: t.numpy(), port(tree)), batch, cache)
            bsh = NamedSharding(jmesh, P(rules.batch, None))
            per_dev = {}
            for d in range(2):
                for m in range(2):
                    dev = jmesh.devices[d, m]
                    jb = jax.tree_util.tree_unflatten(tdef, [
                        x[s.sharding.devices_indices_map(s.shape)[dev]]
                        if s.ndim else x for x, s in zip(nums, flat)])
                    rows = bsh.devices_indices_map((B, S))[dev][0]
                    jc = None
                    if cache is not None:
                        jc = {p: x.numpy() for p, x in cache_items(
                            cache_from_jax(jax.tree_util.tree_unflatten(
                                ctdef, [x[s.sharding.devices_indices_map(
                                    s.shape)[dev]] if s.ndim else x
                                    for x, s in zip(cnums, cflat)])))}
                    per_dev[(d, m)] = (
                        {p: x.numpy() for p, x in tree_lib.items(port(jb))},
                        {k: v[rows] for k, v in batch.items()}, jc)
            whole = ({p: x.numpy().copy() for p, x in cache_items(cache)}
                     if cache is not None else None)
            want[(arch, phase)] = (per_dev, whole)
    return pool.run("ulysses_blocks", runs), want


@pytest.mark.parametrize("phase", ["train", "prefill"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_each_ranks_blocks_rows_and_cache_are_jax(blocks, arch, phase):
    res, want = blocks
    per_dev, whole = want[(arch, phase)]
    cfg = registry.get_config(arch, smoke=True)
    for r in res:
        state, batch, cache, block, mode = r[(arch, phase)]
        w_state, w_batch, w_cache = per_dev[r["coord"]]
        assert sorted(state) == sorted(w_state)
        for p, x in w_state.items():
            np.testing.assert_array_equal(state[p], x, err_msg=p)
        assert sorted(batch) == sorted(w_batch)
        for k, x in w_batch.items():   # one row, the whole sequence
            assert x.shape[0] == B // 2 and x.shape[1] == batch[k].shape[1]
            np.testing.assert_array_equal(batch[k], x)
        assert block == (r["coord"][1] * S // M, S // M)
        if cfg.n_heads:
            assert mode == ("heads" if cfg.n_heads % M == 0 else "seq")
        if whole is None:
            assert cache is None
            continue
        assert sorted(cache) == sorted(whole)
        rows = slice(r["coord"][0] * B // 2, (r["coord"][0] + 1) * B // 2)
        for p, x in whole.items():
            if p.startswith("ssm/"):   # the SSM states: by rows
                np.testing.assert_array_equal(cache[p], x[rows], err_msg=p)
            else:
                np.testing.assert_array_equal(cache[p], w_cache[p],
                                              err_msg=p)


# ---------------------------------------------------------------- vs JAX
JAX_RUNS = {"heads": None, "seq": SEQ_HEADS}


@pytest.fixture(scope="module")
def jax_steps(pool, jmesh):
    """JAX's train step and prefill step under make_rules on the (2, 2)
    mesh and the port's on its 4 ranks, from the same weights and
    inputs."""
    out = {}
    for mode, ov in JAX_RUNS.items():
        jcfg = dataclasses.replace(
            jregistry.get_config("paper-mpfp-100m", smoke=True), **(ov or {}))
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, jp)
        cfg = dataclasses.replace(
            registry.get_config("paper-mpfp-100m", smoke=True), **(ov or {}))
        batch = ulysses_inputs(cfg, B, S)
        rules = jspecs.make_rules(jmesh, _jcell("train"), jcfg)
        st, _ = jspecs.state_structs(jcfg, rules, "float32")
        state = jax.device_put(
            jtrainer.TrainState(jp, jadamw.init(
                jp, jadamw.AdamWConfig(lr=LR))),
            jax.tree_util.tree_map(lambda s: s.sharding, st))
        step = jtrainer.make_train_step(
            jcfg, JPolicy.train_default(), jtrainer.TrainerConfig(
                opt=jadamw.AdamWConfig(lr=LR), total_steps=30, warmup=2))
        prules = jspecs.make_rules(jmesh, _jcell("prefill"), jcfg)
        pre = jtrainer.make_prefill_step(jcfg, JPolicy.serve_default())
        cache = JT.make_cache(jcfg, B, S)
        np_cache = jax.tree_util.tree_map(np.asarray, cache)

        def train(state, batch):
            with jsh.use_rules(rules):
                return step(state, batch)

        def prefill(p, inputs, c):
            with jsh.use_rules(prules):
                return pre(p, inputs, c)

        bsh = NamedSharding(jmesh, P(rules.batch, None))
        with jmesh, jcontext.context(backend="ref"):
            new, metrics = jax.jit(train)(state, {
                k: jax.device_put(jnp.asarray(v, jnp.int32), bsh)
                for k, v in batch.items()})
            last, jcache = jax.jit(prefill)(
                jax.device_put(jp, jax.tree_util.tree_map(
                    lambda s: s.sharding, jspecs.params_structs(
                        jcfg, prules))),
                {"tokens": jax.device_put(jnp.asarray(
                    batch["tokens"], jnp.int32), bsh)},
                jax.device_put(cache, jax.tree_util.tree_map(
                    lambda s: s.sharding, jspecs.cache_structs(
                        jcfg, _jcell("prefill"), prules))))
        new = jax.tree_util.tree_map(np.asarray, new)
        res = pool.run("ulysses_jax_steps", "paper-mpfp-100m", ov,
                       np_params, batch, S, np_cache)
        out[mode] = (res, float(metrics["loss"]), {
            p: x.numpy() for p, x in tree_lib.items(_to_port_state(
                new.params, new.opt.step, new.opt.m, new.opt.v))},
            np.asarray(last), {p: x.float().numpy() for p, x in cache_items(
                cache_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jcache)))})
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


@pytest.mark.parametrize("mode", list(JAX_RUNS))
def test_the_train_step_is_jax_under_make_rules(jax_steps, mode):
    res, loss, want, _, _ = jax_steps[mode]
    for r in res[1:]:
        assert r["loss"] == res[0]["loss"]
        for p, x in r["new"].items():
            np.testing.assert_array_equal(x, res[0]["new"][p])
    r = res[0]
    assert abs(r["loss"] - loss) <= 1e-5 * abs(loss)
    assert sorted(r["new"]) == sorted(want)
    for p, w in want.items():
        assert r["new"][p].shape == w.shape, p
        if p == "1/0":
            assert int(r["new"][p]) == int(w) == 1
            continue
        assert _rel(r["new"][p], w) < GRAD_BOUND, p


@pytest.mark.parametrize("mode", list(JAX_RUNS))
def test_the_prefill_step_is_jax_under_make_rules(jax_steps, mode):
    res, _, _, last, cache = jax_steps[mode]
    for r in res:
        rows = slice(*r["rows"])
        np.testing.assert_allclose(r["last"], last[rows], rtol=0,
                                   atol=M8 * np.abs(last).max())
        assert sorted(r["cache"]) == sorted(cache)
        for p, w in cache.items():
            np.testing.assert_allclose(r["cache"][p], w, rtol=0,
                                       atol=M8 * np.abs(w).max(), err_msg=p)
            assert np.abs(w).max() > 0, p


# ---------------------------------------------------------------- vs one rank
@pytest.fixture(scope="module")
def one_rank(pool):
    cache = {}

    def get(name):
        if name not in cache:
            arch, _, fused = RUNS[name]
            cache[name] = pool.run("ulysses_vs_one_rank", arch,
                                   _overrides(name), B, S, fused)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(RUNS))
def test_forward_and_prefill_are_the_one_rank_bits(one_rank, name):
    """Every rank's rows and block of the forward's logits, the prefill's
    last logits and the gathered cache: bitwise the one-rank step's."""
    res = one_rank(name)
    cfg = _cfg(name)
    seen = set()
    for r in res:
        off, t = r["block"]
        assert (off, t) == (r["coord"][1] * S // M, S // M)
        if cfg.n_heads:
            assert r["mode"] == ("heads" if cfg.n_heads % M == 0
                                 else "seq")
        np.testing.assert_array_equal(r["logits"], r["one_logits"])
        np.testing.assert_array_equal(r["last"], r["one_last"])
        assert sorted(r["cache"]) == sorted(r["one_cache"])
        for p, w in r["one_cache"].items():
            np.testing.assert_array_equal(r["cache"][p], w, err_msg=p)
        seen |= {(i, j) for i in range(*r["rows"])
                 for j in range(off, off + t)}
    assert seen == {(i, j) for i in range(B) for j in range(S)}


@pytest.mark.parametrize("name", list(RUNS))
def test_loss_and_gradients_are_the_one_rank_step(one_rank, name):
    for r in one_rank(name):
        assert abs(r["loss"] - r["one_loss"]) <= 1e-5 * abs(r["one_loss"])
        assert sorted(r["grads"]) == sorted(r["one_grads"])
        for p, w in r["one_grads"].items():
            assert r["grads"][p].shape == w.shape, p
            assert _rel(r["grads"][p], w) < GRAD_BOUND, p
        for k in ("loss", "nll", "grad_norm", "params_finite"):
            np.testing.assert_array_equal(r["metrics"][k],
                                          one_rank(name)[0]["metrics"][k])


def _attn_layers(cfg):
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def _kv_width(cfg):
    """(K / V heads exchanged or gathered, K's head dim, V's): MLA's
    per-head K and padded V; GQA's K / V before the repeat where the model
    axis divides them."""
    if cfg.mla is not None:
        return cfg.n_heads, cfg.mla.qk_head_dim, cfg.mla.qk_head_dim
    hk = cfg.n_kv_heads if cfg.n_kv_heads % M == 0 else cfg.n_heads
    if cfg.n_heads % M:   # seq mode gathers before the repeat
        hk = cfg.n_kv_heads
    return hk, cfg.resolved_head_dim, cfg.resolved_head_dim


def _formula(cfg, coord, phase):
    """A step's collectives on one rank ({name: (calls, bytes)}).

    Parameters (FSDP blocks over data's 2 ranks): all_gather one per
    sharded leaf (the block), again per layer leaf in a train step's remat
    recompute; in a train step's backward reduce_scatter one per sharded
    leaf (the whole cotangent), then all_reduce over model one per sharded
    leaf (the block) and over every rank one per replicated leaf, the
    clipping norm (4 bytes) and the metrics (3 floats).  Attention (f32,
    per layer): heads mode 4 all_to_all of (1 row, t, H, Dh) — q, k, v
    (k / v at the heads exchanged) and the output; seq mode 2 all_gather
    of K / V's block, in a train step's backward their reduce_scatter
    (the whole); both again in the recompute.  The SSM: per layer the
    conv window (3 x conv_dim) and the final state (H x P x N) sent to
    the next block (model rank 0) or received (rank 1), again in the
    recompute, the backward the other way.  A prefill: its last logits
    and each Mamba2 layer's two states broadcast from the last block."""
    full = dict(tree_lib.items(T.init_params(cfg, device="meta")))
    nb = {p: x.numel() * x.element_size() for p, x in full.items()}
    sharded = [p for p, x in full.items() if x.ndim and x.shape[-1] % 2 == 0]
    reps = [p for p in full if p not in sharded]
    train = phase == "train"
    again = ([p for p in sharded if p.split("/")[0] in ("layers",
                                                          "shared_lora")]
             if train else [])
    c = {"all_gather": [len(sharded) + len(again),
                        sum(nb[p] // 2 for p in sharded + again)]}
    if train:
        c["reduce_scatter"] = [len(sharded), sum(nb[p] for p in sharded)]
        c["all_reduce"] = [len(sharded) + len(reps) + 2,
                           sum(nb[p] // 2 for p in sharded)
                           + sum(nb[p] for p in reps) + 4 + 12]
    t = S // M
    n_att = _attn_layers(cfg)
    passes = 3 if train else 1           # forward, recompute, backward
    if n_att:
        H = cfg.n_heads
        hk, dk, dv = _kv_width(cfg)
        if H % M == 0:   # q, k, v and the output (V's width)
            per = 4 * t * (H * dk + hk * dk + hk * dv + H * dv)
            c["all_to_all"] = [4 * n_att * passes, n_att * passes * per]
        else:
            kv = 4 * t * hk * (dk + dv)
            c["all_gather"][0] += 2 * n_att * (2 if train else 1)
            c["all_gather"][1] += kv * n_att * (2 if train else 1)
            if train:
                c["reduce_scatter"][0] += 2 * n_att
                c["reduce_scatter"][1] += M * kv * n_att
    if cfg.ssm is not None:
        d = cfg.ssm
        carry = 4 * (3 * d.conv_dim + d.n_heads * d.head_dim * d.d_state)
        n_ssm = cfg.n_layers
        fwd = 2 if train else 1          # forward and the recompute
        first = coord[1] == 0
        c["send"] = [2 * n_ssm * (fwd if first else (1 if train else 0)),
                     n_ssm * carry * (fwd if first else (1 if train else 0))]
        c["recv"] = [2 * n_ssm * (fwd if not first else (1 if train else 0)),
                     n_ssm * carry * (fwd if not first
                                      else (1 if train else 0))]
    if phase == "prefill":
        n_b = 1 + (2 * cfg.n_layers if cfg.ssm is not None else 0)
        V = cfg.vocab
        state_b = 0
        if cfg.ssm is not None:
            d = cfg.ssm
            state_b = cfg.n_layers * 4 * (
                3 * d.conv_dim + d.n_heads * d.head_dim * d.d_state)
        c["broadcast"] = [n_b, 4 * V + state_b]
    return {k: tuple(v) for k, v in c.items() if v[0]}


@pytest.mark.parametrize("name", list(RUNS))
def test_collectives_are_the_formula(one_rank, name):
    cfg = _cfg(name)
    for r in one_rank(name):
        assert r["step_collectives"] == _formula(cfg, r["coord"], "train")
        assert r["prefill_collectives"] == _formula(cfg, r["coord"],
                                                    "prefill")


@pytest.mark.parametrize("name", list(RUNS))
def test_plain_calls_are_the_one_rank_formula_at_the_block(one_rank, name):
    """The forward's kernel calls on the layout are the one-rank step's
    (here, on CPU tensors, their plain versions': the card runs the same
    calls as launches), but for the chunk-scan's query chunks in seq mode:
    the rank's block's (QK and PV a query chunk a kv chunk)."""
    cfg = _cfg(name)
    for r in one_rank(name):
        want = dict(r["one_fwd_calls"])
        if RUNS[name][2] is not None and cfg.n_heads % M:
            q = cfg.attn_q_chunk
            want["mp_fused_matmul"] -= (2 * ((S - S // M) // q) * (S // q)
                                        * _attn_layers(cfg))
        assert r["fwd_calls"] == want
        assert r["step_calls"] and r["prefill_calls"]


@pytest.mark.parametrize("name", list(RUNS))
def test_resident_bytes_are_the_layouts(one_rank, name):
    """A rank's state: each sharded leaf's half (data's 2 ranks), params
    and f32 moments, + the 0-d step; its batch: one row of every input at
    the whole sequence; its prefill cache: one row, the sequence tensors'
    block, the SSM states whole."""
    cfg = _cfg(name)
    full = dict(tree_lib.items(T.init_params(cfg, device="meta")))
    blocks = sum(x.numel() * x.element_size() // (
        2 if x.ndim and x.shape[-1] % 2 == 0 else 1) for x in full.values())
    inputs = ulysses_inputs(cfg, B, S)
    for r in one_rank(name):
        assert r["state_bytes"] == 3 * blocks + 4
        assert r["params_bytes"] == blocks
        assert r["batch_bytes"] == sum(v.nbytes // B for v in inputs.values())
        if cfg.encoder_only:
            continue
        want = sum(x.numel() * x.element_size() // B // (
            M if p.split("/")[-1] in ("k", "v", "c_kv", "k_rope") else 1)
            for p, x in cache_items(T.make_cache(cfg, B, S, device="meta")))
        assert r["cache_bytes"] == want


# ---------------------------------------------------------------- edges
def test_an_ssm_block_off_its_chunk_and_a_longer_cache_raise(pool):
    """Blocks of 24 positions do not tile mamba2's SSD chunks of 16; a
    prefill of 32 positions into a cache of 64 would write the rank's
    positions into another rank's cache block."""
    for r in pool.run("ulysses_edges", 48):
        assert "chunk" in r["chunk"] and "16" in r["chunk"]
        assert "longer than its prompt" in r["long"] \
            and "whole-rank" in r["long"]


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


def test_the_moe_family_refuses_the_layout():
    cfg = registry.get_config("deepseek-v2-lite-16b", smoke=True)
    params = T.init_params(cfg, device="meta")
    tokens = torch.zeros((1, 16), dtype=torch.int64, device="meta")
    layout = sl.SeqLayout(rules=None, fsdp=None, seq_len=16)
    with sl.use_seq_layout(layout):
        with pytest.raises(NotImplementedError, match="item 2d"):
            T.forward(params, {"tokens": tokens}, cfg,
                      PrecisionPolicy.train_default())


def test_no_layout_runs_nothing_of_it():
    """With no layout installed the forward and a prefill take the
    one-rank path: the same bits with ``use_seq_layout(None)`` as without,
    and no collective."""
    from repro_torch.dist import collectives
    from repro_torch.serve.engine import make_prefill_step

    cfg = registry.get_config("zamba2-2.7b", smoke=True)
    params = T.init_params(cfg)
    toks = torch.as_tensor(ulysses_inputs(cfg, B, S)["tokens"])
    pol = PrecisionPolicy.serve_default()
    collectives.reset_counts()
    with torch.no_grad():
        a, ca = make_prefill_step(cfg, pol)(params, {"tokens": toks},
                                            T.make_cache(cfg, B, S))
        with sl.use_seq_layout(None):
            b, cb = make_prefill_step(cfg, pol)(params, {"tokens": toks},
                                                T.make_cache(cfg, B, S))
    assert torch.equal(a, b)
    for (p, x), (_, y) in zip(cache_items(ca), cache_items(cb)):
        assert torch.equal(x, y), p
    assert not any(v["calls"] for v in collectives.counts().values())


@pytest.mark.parametrize("arch,rows,phase,force,seq", [
    ("paper-mpfp-100m", 2, "train", "", True),
    ("paper-mpfp-100m", 2, "prefill", "", True),
    ("mamba2-130m", 2, "prefill", "", True),
    ("hubert-xlarge", 2, "prefill", "", True),
    ("paper-mpfp-100m", 4, "train", "", False),     # pure FSDP
    ("paper-mpfp-100m", 2, "decode", "", False),    # the decode layout
    ("paper-mpfp-100m", 1, "train", "", False),     # no batch axes
    ("deepseek-v2-lite-16b", 2, "train", "", False),  # MoE
    ("paper-mpfp-100m", 2, "prefill", "tp", False),   # Megatron TP
])
def test_seq_layout_is_decided_by_make_rules(arch, rows, phase, force, seq,
                                             monkeypatch):
    """``specs.seq_layout``: a train or prefill cell under rules with
    sequence axes, batch axes and no TP, of a family without MoE layers;
    the prefill's cache laid out as the decode layout's."""
    monkeypatch.setenv("REPRO_FORCE_LAYOUT", force)
    cfg = registry.get_config(arch, smoke=True)
    mesh = CoordMesh({"data": 2, "model": 2}, (1, 1))
    cell = ShapeCell("smoke", 64, rows, phase)
    rules = specs.make_rules(mesh, cell, cfg)
    layout = specs.seq_layout(cfg, cell, rules)
    assert (layout is not None) == seq
    if layout is None:
        return
    assert layout.block == (32, 32) and layout.size == 2
    assert layout.rows(rows) == slice(1, 2)
    assert isinstance(layout.rules, AxisRules)
    assert (layout.cache is not None) == (phase == "prefill"
                                          and not cfg.encoder_only)
    if phase == "train":
        assert specs.train_layout(cfg, cell, rules).rules == rules
    assert all(fsdp.is_sharded(s) == (x.ndim > 0 and x.shape[-1] % 2 == 0)
               for (_, s), x in zip(tree_lib.items(layout.params),
                                    tree_lib.leaves(T.init_params(
                                        cfg, device="meta"))))
