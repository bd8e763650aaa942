"""PyTorch port: the decode layout of the serve step
(``dist/decode_layout.py``, ``make_serve_step(layout=specs.decode_layout(
...))``) against the JAX package's ``make_rules`` / ``cache_specs`` layout
and against the port's one-rank step.

The port runs in 4 gloo ranks (tests/torch_dist_pool.py) on a (data 2,
model 2) mesh; JAX on a (2, 2) mesh of 4 of its 8 fake CPU devices.  Two
cells: ``rows`` (batch 4, a cache of 32: rows over ``data``, the cache
sequence over ``model``) and ``context`` (batch 1, a cache of 64: no batch
axes, the sequence over (``data``, ``model``), parameters whole).

* **Blocks are JAX's.**  Every cache tensor of every non-MoE decode family,
  numbered: each rank's block equals the block JAX's
  ``devices_indices_map`` gives the device at the same mesh coordinates,
  the leading L stripped.  The SSM states are the stated exception: JAX's
  ``cache_specs`` reads dim 2 of every leaf of four dims or more as the
  sequence, which is the hybrid's batch in its grouped (G, every, B, ...)
  states and the heads in the SSM family's (L, B, H, P, N) state; the
  port lays these out by the activations' rows (``data``), as every other
  tensor of the same rows.
* **The step is JAX's.**  paper-mpfp-100m and minicpm3-4b (MLA): JAX's
  ``make_serve_step`` under ``use_rules(make_rules(...))`` with params and
  cache ``device_put`` to their shardings; the port's 4-rank step on
  ``cache_from_jax`` of the same cache: logits within
  tests/test_torch_arch.py's serve_default bound, the new cache JAX's.
* **The step is the one-rank step.**  Each family, both cells, under
  serve_default and full_fp32, 3 teacher-forced steps that cross a block
  boundary: logits within the policy's bound, equal-row ranks bitwise,
  the gathered cache the one-rank cache (unwritten positions and the
  first attention layer's writes bitwise, later layers within the bound:
  the sequence-parallel softmax sums in another order), the collectives
  of the formula, the rank's resident bytes the layout's arithmetic.
* Edges: a block with no valid position adds nothing; AUTO raises; the
  ``sharded`` backend's ``sp_decode_attention`` keeps its bits; the MoE
  family refuses the layout; ``specs.decode_layout``'s decision.
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
from repro.train import trainer as jtrainer
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeCell
from repro_torch.core.formats import resolve
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import decode_layout as dl
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from repro_torch.weights import cache_from_jax
from torch_dist_cases import cache_items
from torch_dist_pool import RankPool

WORLD = 4
FAMILIES = ("paper-mpfp-100m", "minicpm3-4b", "llava-next-34b",
            "mamba2-130m", "zamba2-2.7b")
# cell: (batch, cache length, prefilled length); three steps write
# positions length .. length + 2, across the block boundary at 16 (rows)
# and 32 (context, whose last block has no valid position)
CELLS = {"rows": (4, 32, 14), "context": (1, 64, 30)}
STEPS = 3
BOUNDS = {"serve_default": resolve("M8").rel_err_bound, "full_fp32": 1e-5}


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


def _jcell(cell):
    B, S, _ = CELLS[cell]
    return JShapeCell("smoke", S, B, "decode")


def _is_grouped_ssm(path):
    return path.startswith("ssm/")


# ---------------------------------------------------------------- blocks
@pytest.fixture(scope="module")
def blocks(pool, jmesh):
    """Every family's numbered cache in both cells, each rank's blocks,
    and JAX's blocks of the same numbers for the device at each rank's
    coordinates, with JAX's spec of each leaf and its batch rows."""
    runs, want = {}, {}
    for arch in FAMILIES:
        jcfg = jregistry.get_config(arch, smoke=True)
        for cell in CELLS:
            B, S, _ = CELLS[cell]
            rules = jspecs.make_rules(jmesh, _jcell(cell), jcfg)
            st = jspecs.cache_structs(jcfg, _jcell(cell), rules)
            flat, tdef = jax.tree_util.tree_flatten(st)
            nums = [np.arange(s.size, dtype=np.float32).reshape(s.shape)
                    if s.ndim else np.zeros((), np.int32) for s in flat]
            tree = jax.tree_util.tree_unflatten(tdef, nums)
            runs[(arch, cell)] = (arch, B, S, cache_from_jax(tree))
            bsh = NamedSharding(jmesh, P(rules.batch, None))
            per_dev = {}
            for d in range(2):
                for m in range(2):
                    dev = jmesh.devices[d, m]
                    jb = jax.tree_util.tree_unflatten(tdef, [
                        x[s.sharding.devices_indices_map(s.shape)[dev]]
                        if s.ndim else x for x, s in zip(nums, flat)])
                    rows = bsh.devices_indices_map((B, 1))[dev][0]
                    per_dev[(d, m)] = (
                        {p: x.numpy() for p, x in
                         cache_items(cache_from_jax(jb))}, rows)
            whole = {p: x.numpy() for p, x in
                     cache_items(cache_from_jax(tree))}
            jspec = _leaf_specs(st)
            want[(arch, cell)] = (per_dev, whole, jspec)
    got = pool.run("decode_blocks", runs)
    return got, want


def _leaf_specs(st):
    """JAX's spec of each leaf group: {"attn/k": spec, ...}."""
    out = {}
    for group in ("attn", "dense_attn", "ssm", "shared_attn"):
        sub = getattr(st, group)
        if sub is None:
            continue
        for f in sub._fields:
            out[f"{group}/{f}"] = tuple(getattr(sub, f).sharding.spec)
    return out


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_each_ranks_cache_blocks_are_jax(blocks, arch, cell):
    got, want = blocks
    per_dev, whole, _ = want[(arch, cell)]
    B, S, _ = CELLS[cell]
    for r in got:
        mine, rows, seq_block = r[(arch, cell)]
        w_blocks, w_rows = per_dev[r["coord"]]
        assert rows == (w_rows.start or 0, w_rows.stop or B)
        assert sorted(mine) == sorted(whole)
        for p, x in w_blocks.items():
            if _is_grouped_ssm(p):
                continue
            np.testing.assert_array_equal(mine[p], x, err_msg=p)
        # the SSM states: the activations' rows, whole otherwise
        for p, x in whole.items():
            if _is_grouped_ssm(p):
                np.testing.assert_array_equal(
                    mine[p], x[w_rows], err_msg=p)
        if any(p.split("/")[-1] in ("k", "c_kv") for p in whole):
            n = 2 if cell == "rows" else 4
            idx = (r["coord"][1] if cell == "rows"
                   else 2 * r["coord"][0] + r["coord"][1])
            assert seq_block == (idx * S // n, S // n)


@pytest.mark.parametrize("cell", list(CELLS))
def test_jax_lays_the_ssm_states_out_by_dim_2(blocks, cell):
    """The recorded JAX finding: ``cache_specs`` shards dim 2 of every
    leaf of four dims or more over the sequence axes, so the hybrid's
    grouped (G, every, B, ...) states put their batch there and the SSM
    family's (L, B, H, P, N) state its heads."""
    _, want = blocks
    seq = "model" if cell == "rows" else ("data", "model")
    batch = "data" if cell == "rows" else None
    hyb = want[("zamba2-2.7b", cell)][2]
    ssm = want[("mamba2-130m", cell)][2]
    if cell == "rows":   # every 2 divides data 2, B 4 divides model 2
        assert hyb["ssm/conv"] == (None, "data", "model", None, None)
        assert hyb["ssm/state"] == (None, "data", "model", None, None,
                                    None)
    else:                # B 1 does not divide the four ranks
        assert hyb["ssm/state"][2] is None
    assert ssm["ssm/state"] == (None, batch, seq, None, None)
    assert ssm["ssm/conv"] == (None, batch, None, None)


# ---------------------------------------------------------------- vs JAX
JAX_ARCHS = ("paper-mpfp-100m", "minicpm3-4b")


@pytest.fixture(scope="module")
def jax_step(pool, jmesh):
    """The rows cell's prefilled cache (JAX, one device), then one
    serve_default step: JAX's under make_rules on the (2, 2) mesh and the
    port's on its 4 ranks."""
    out = {}
    B, S, length = CELLS["rows"]
    for arch in JAX_ARCHS:
        jcfg = jregistry.get_config(arch, smoke=True)
        policy = JPolicy.serve_default()
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(3)
        prompt = jnp.asarray(rng.integers(0, jcfg.vocab, (B, length)),
                             jnp.int32)
        tok = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        rules = jspecs.make_rules(jmesh, _jcell("rows"), jcfg)
        shard = lambda st: jax.tree_util.tree_map(  # noqa: E731
            lambda s: s.sharding, st)
        step = jtrainer.make_serve_step(jcfg, policy)

        def fn(p, c, t):
            with jsh.use_rules(rules):
                return step(p, c, t)

        with jcontext.context(backend="ref"):
            _, cache = jax.jit(jtrainer.make_prefill_step(jcfg, policy))(
                jp, {"tokens": prompt}, JT.make_cache(jcfg, B, S))
            with jmesh:
                logits, new = jax.jit(fn)(
                    jax.device_put(jp, shard(jspecs.params_structs(
                        jcfg, rules))),
                    jax.device_put(cache, shard(jspecs.cache_structs(
                        jcfg, _jcell("rows"), rules))),
                    jax.device_put(jnp.asarray(tok), NamedSharding(
                        jmesh, P(rules.batch, None))))
        np_cache = jax.tree_util.tree_map(np.asarray, cache)
        res = pool.run("decode_jax_step", arch, B, S,
                       jax.tree_util.tree_map(np.asarray, jp), np_cache, tok)
        out[arch] = (res, np.asarray(logits)[:, -1],
                     {p: x.float().numpy() for p, x in cache_items(
                         cache_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               new)))},
                     {p: x.float().numpy() for p, x in cache_items(
                         cache_from_jax(np_cache))})
    return out


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_the_step_is_jax_under_make_rules(jax_step, arch):
    res, jl, jnew, before = jax_step[arch]
    tol = BOUNDS["serve_default"] * np.abs(jl).max()
    for r in res:
        rows = slice(*r["rows"])
        np.testing.assert_allclose(r["logits"], jl[rows], rtol=0, atol=tol)
        assert r["length"] == CELLS["rows"][2] + 1
    pos = CELLS["rows"][2]
    for r in res:
        assert sorted(r["cache"]) == sorted(jnew)
        for p, w in jnew.items():
            got = r["cache"][p]
            # the positions the step did not write: bitwise the prefill's
            keep = np.ones(got.shape[1], bool)
            keep[pos] = False
            np.testing.assert_array_equal(got[:, keep], w[:, keep],
                                          err_msg=p)
            np.testing.assert_array_equal(got[:, keep], before[p][:, keep],
                                          err_msg=p)
            # the written one: JAX's, within the serve_default bound
            np.testing.assert_allclose(
                got[:, pos], w[:, pos], rtol=0,
                atol=BOUNDS["serve_default"] * np.abs(w[:, pos]).max(),
                err_msg=p)
        if r["rows"] == res[0]["rows"]:
            np.testing.assert_array_equal(r["logits"], res[0]["logits"])


# ---------------------------------------------------------------- vs one rank
@pytest.fixture(scope="module")
def one_rank(pool):
    cache = {}

    def get(arch, cell, policy):
        key = (arch, cell, policy)
        if key not in cache:
            B, S, length = CELLS[cell]
            cache[key] = pool.run("decode_vs_one_rank", arch, B, S, length,
                                  STEPS, policy)
        return cache[key]

    return get


PARAMS = [(a, c, p) for a in FAMILIES for c in CELLS for p in BOUNDS]


@pytest.mark.parametrize("arch,cell,policy", PARAMS)
def test_row_logits_are_the_one_rank_step(one_rank, arch, cell, policy):
    res = one_rank(arch, cell, policy)
    B = CELLS[cell][0]
    rows_n = 2 if cell == "rows" else 1
    seen = []
    for r in res:
        rows = slice(*r["rows"])
        seen += list(range(B))[rows]
        for lg, one in zip(r["logits"], r["one_logits"]):
            np.testing.assert_allclose(
                lg, one[rows], rtol=0,
                atol=BOUNDS[policy] * np.abs(one).max())
    # each row on the ranks of one data coordinate (batch 1: every rank)
    assert sorted(seen) == sorted(list(range(B)) * (WORLD // rows_n))


@pytest.mark.parametrize("arch,cell,policy", PARAMS)
def test_ranks_holding_the_same_rows_agree_bitwise(one_rank, arch, cell,
                                                   policy):
    res = one_rank(arch, cell, policy)
    by_rows = {}
    for r in res:
        by_rows.setdefault(r["rows"], []).append(r)
    assert len(by_rows) == (2 if cell == "rows" else 1)
    for group in by_rows.values():
        for r in group[1:]:
            for a, b in zip(r["logits"], group[0]["logits"]):
                np.testing.assert_array_equal(a, b)


def _first_attention(path):
    return path.startswith(("attn/0/", "shared_attn/0/"))


@pytest.mark.parametrize("arch,cell,policy", PARAMS)
def test_gathered_cache_is_the_one_rank_cache(one_rank, arch, cell, policy):
    """Unwritten positions and the first attention layer's writes bitwise
    (the same projections of the same inputs on the same routes); the
    later layers' writes and the SSM states within the policy's bound of
    each tensor's max (their inputs passed a sequence-parallel softmax,
    summed in another order)."""
    res = one_rank(arch, cell, policy)
    B, S, length = CELLS[cell]
    new = slice(length, length + STEPS)
    for r in res:
        assert sorted(r["cache"]) == sorted(r["one_cache"])
        for p, w in r["one_cache"].items():
            got = r["cache"][p]
            tol = BOUNDS[policy] * max(np.abs(w).max(), 1e-30)
            if p.split("/")[-1] in ("k", "v", "c_kv", "k_rope"):
                keep = np.ones(S, bool)
                keep[new] = False
                np.testing.assert_array_equal(got[:, keep], w[:, keep],
                                              err_msg=p)
                assert np.abs(w[:, new]).max() > 0, p
                if _first_attention(p):
                    np.testing.assert_array_equal(got[:, new], w[:, new],
                                                  err_msg=p)
                else:
                    np.testing.assert_allclose(got[:, new], w[:, new],
                                               rtol=0, atol=tol, err_msg=p)
            else:
                np.testing.assert_allclose(got, w, rtol=0, atol=tol,
                                           err_msg=p)


@pytest.mark.parametrize("arch,cell", [(a, c) for a in FAMILIES
                                       for c in CELLS if a != "mamba2-130m"])
def test_each_write_lands_on_the_rank_whose_block_holds_it(one_rank, arch,
                                                           cell):
    """The first sequence tensor of each rank after the steps is its block
    of the one-rank cache, bitwise (the first attention layer's writes are
    the same projections): the positions the steps wrote, across the block
    boundary (rows: 14, 15 on the model-0 ranks, 16 on the model-1 ranks),
    land only on the rank whose block holds them."""
    res = one_rank(arch, cell, "serve_default")
    B, S, length = CELLS[cell]
    wrote = set()
    for r in res:
        path, blk = r["first_block"]
        off, t = r["seq_block"]
        rows = slice(*r["rows"])
        np.testing.assert_array_equal(
            blk, r["one_cache"][path][rows, off:off + t], err_msg=path)
        for pos in range(length, length + STEPS):
            if off <= pos < off + t:
                assert np.abs(blk[:, pos - off]).max() > 0
                wrote.add(pos)
    assert wrote == set(range(length, length + STEPS))


@pytest.mark.parametrize("arch,cell", [(a, c) for a in FAMILIES
                                       for c in CELLS])
def test_a_step_calls_the_one_rank_steps_kernels(one_rank, arch, cell):
    """Each wrapper's calls a step on the layout are the one-rank step's
    (here, on CPU tensors, its plain version's: the card runs the same
    calls as launches)."""
    for r in one_rank(arch, cell, "serve_default"):
        for got, want in zip(r["calls"], r["one_calls"]):
            assert got == want and any(want.values())


def _attn_layers(cfg):
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


@pytest.mark.parametrize("arch,cell,policy", PARAMS)
def test_collectives_and_resident_bytes_are_the_formula(one_rank, arch,
                                                        cell, policy):
    """Per step and rank: all_gather one per sharded parameter leaf (the
    rank's block; none at batch 1), all_reduce 3 per attention layer over
    the sequence group: the row maxima and exp-sums (B_loc x H f32 each)
    and the partial P.V (B_loc x H x Dh f32; MLA's context B_loc x H x
    kv_lora); nothing else.  Resident: the parameters' and the cache's
    blocks."""
    cfg = registry.get_config(arch, smoke=True)
    B, S, _ = CELLS[cell]
    rows_n, seq_n = (2, 2) if cell == "rows" else (1, 4)
    b_loc = B // rows_n
    full = dict(tree_lib.items(T.init_params(cfg, device="meta")))
    nb = {p: x.numel() * x.element_size() for p, x in full.items()}
    r = one_rank(arch, cell, policy)[0]
    sharded = set(r["sharded_params"])
    if cell == "rows":
        assert sharded == {p for p, x in full.items()
                           if x.ndim and x.shape[-1] % rows_n == 0}
    else:
        assert not sharded
    width = cfg.mla.kv_lora if cfg.mla is not None else cfg.resolved_head_dim
    per_layer = 4 * b_loc * cfg.n_heads * (2 + width)
    want = {"all_gather": (len(sharded), sum(nb[p] // rows_n
                                             for p in sharded)),
            "all_reduce": (3 * _attn_layers(cfg),
                           _attn_layers(cfg) * per_layer)}
    for counts in r["counts"]:
        got = {k: (v["calls"], v["bytes"]) for k, v in counts.items()
               if v["calls"] and k in ("all_gather", "all_reduce",
                                       "reduce_scatter", "all_to_all",
                                       "broadcast", "send", "recv")}
        assert got == {k: v for k, v in want.items() if v[0]}
    cache = T.make_cache(cfg, B, S, device="meta")
    cache_bytes = sum(
        x.numel() * x.element_size() // rows_n
        // (seq_n if p.split("/")[-1] in ("k", "v", "c_kv", "k_rope")
            else 1) for p, x in cache_items(cache))
    params_bytes = sum(nb[p] // (rows_n if p in sharded else 1)
                       for p in full)
    assert r["resident"] == cache_bytes + params_bytes


# ---------------------------------------------------------------- edges
def test_block_edges_auto_and_the_sharded_entrys_bits(pool):
    """Over (data, model) blocks of 8 of a 32-position cache: the lengths
    leave blocks 2 and 3 without a valid position in one slot; junk past
    every length changes no bit; AUTO raises naming the reason; three
    all-reduces; and ``sp_decode_attention`` (the sharded backend's path,
    4 ranks over ``data``, a ragged T split) is bitwise its formula before
    ``sp_decode_block`` split from it."""
    rng = np.random.default_rng(4)
    B, T_, H, Dh = 2, 32, 4, 16
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T_, H, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T_, H, Dh)).astype(np.float32)
    lengths = np.asarray([11, 27], np.int32)
    junk = 1e3 * rng.standard_normal((B, T_, H, Dh)).astype(np.float32)
    res = pool.run("decode_edges", q, k, v, lengths, junk)
    for r in res:
        np.testing.assert_array_equal(r["clean"], res[0]["clean"])
        np.testing.assert_array_equal(r["dirty"], r["clean"])
        assert "AUTO" in r["auto"] and "whole" in r["auto"]
        assert r["counts"]["calls"] == 3
        assert r["sp_bits"]
        np.testing.assert_array_equal(r["sp"], res[0]["sp"])
    assert sorted(r["block"] for r in res) == [(0, 8), (8, 8), (16, 8),
                                               (24, 8)]
    # against the one-rank masked attention on the whole operand
    from repro_torch.core.dispatch import masked_decode_attention

    one = masked_decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v),
                                  torch.as_tensor(lengths), "M16",
                                  backend="cuda").numpy()
    np.testing.assert_allclose(res[0]["clean"], one, rtol=0,
                               atol=BOUNDS["serve_default"]
                               * np.abs(one).max())


def test_the_moe_family_refuses_the_decode_layout():
    cfg = registry.get_config("deepseek-v2-lite-16b", smoke=True)
    params = T.init_params(cfg, device="meta")
    tokens = torch.zeros((1, 1), dtype=torch.int64, device="meta")
    layout = dl.DecodeLayout(rules=None, fsdp=None, cache=None, seq=None,
                             seq_len=0)
    with dl.use_decode_layout(layout):
        with pytest.raises(NotImplementedError, match="item 2d"):
            T.forward(params, {"tokens": tokens}, cfg,
                      PrecisionPolicy.serve_default())


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


@pytest.mark.parametrize("arch,rows,phase,force,seq,fsdp", [
    ("paper-mpfp-100m", 4, "decode", "", "model", True),
    ("mamba2-130m", 4, "decode", "", "model", True),
    ("zamba2-2.7b", 1, "decode", "", ("data", "model"), False),
    ("minicpm3-4b", 1, "decode", "", ("data", "model"), False),
    ("deepseek-v2-lite-16b", 4, "decode", "", None, None),  # MoE
    ("paper-mpfp-100m", 4, "decode", "tp", None, None),     # Megatron TP
    ("paper-mpfp-100m", 4, "prefill", "", None, None),
    ("paper-mpfp-100m", 4, "train", "", None, None),
])
def test_decode_layout_is_decided_by_make_rules(arch, rows, phase, force,
                                                seq, fsdp, monkeypatch):
    """``specs.decode_layout``: a decode cell under rules without TP of a
    family without MoE layers; the cache sequence over ``model``, or every
    axis at batch 1 (``_cache_seq_axes``, JAX's); parameters in FSDP
    blocks where the batch has axes."""
    monkeypatch.setenv("REPRO_FORCE_LAYOUT", force)
    cfg = registry.get_config(arch, smoke=True)
    mesh = CoordMesh({"data": 2, "model": 2}, (1, 1))
    cell = ShapeCell("smoke", 64, rows, phase)
    rules = specs.make_rules(mesh, cell, cfg)
    layout = specs.decode_layout(cfg, cell, rules)
    assert (layout is not None) == (seq is not None)
    if layout is None:
        return
    jrules = jspecs.make_rules(_JMesh(), JShapeCell("smoke", 64, rows,
                                                    phase),
                               jregistry.get_config(arch, smoke=True))
    assert specs._cache_seq_axes(mesh, cell, rules) == \
        jspecs._cache_seq_axes(_JMesh(), JShapeCell("smoke", 64, rows,
                                                    phase), jrules)
    has_seq = cfg.family != "ssm"
    assert layout.seq == (seq if has_seq else None)
    assert (layout.fsdp is not None) == fsdp
    assert layout.size == (2 if fsdp else 1)
    if has_seq:
        n = 2 if seq == "model" else 4
        idx = 1 if seq == "model" else 3
        assert layout.seq_block == (idx * 64 // n, 64 // n)


class _JMesh:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}
