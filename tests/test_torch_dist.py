"""The port's distributed layer against the JAX package: the hierarchical
collectives, gradient compression, GPipe, sharding rules and elastic
restore.  The JAX side runs in this process on its 8 fake CPU devices
(tests/conftest.py); the port's side in 4 gloo ranks started once for the
module (tests/torch_dist_pool.py), on a (pod 2, data 2, model 1) mesh where
JAX's is (2, 2, 2) and a (data 1, model 4) mesh where JAX's is (2, 4): the
same replica counts and stage counts.

Tolerances: the collectives' f32 sums of the same terms in another
association, rtol 1e-6 (tests/test_collectives.py); the pipeline against
the sequential loop and JAX, tests/test_pipeline.py's 2e-5 and its 1e-4 on
gradient norms; compression, the same f32 ops on the same values, rtol
1e-6; layouts and restored shards exactly."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.checkpoint import checkpoint as jckpt
from repro.core import PrecisionMode, mp_dense as jmp_dense
from repro.dist import collectives as jcoll
from repro.dist import pipeline as jpipe
from repro.dist import sharding as jsh
from repro.optim import compress as jcompress
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.dist import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import compress
from torch_dist_pool import RankPool

WORLD = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.close()


@pytest.fixture(scope="module")
def mesh3():
    return jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


def _same_on_every_rank(results, pick=lambda r: r):
    first = pick(results[0])
    for r in results[1:]:
        np.testing.assert_array_equal(pick(r), first)


# ------------------------------------------------------------------ mesh
def test_meshes_cached_and_production_refused(pool):
    res = pool.run("meshes")
    for r in res:
        assert r["matmul"] == {"data": WORLD} and r["cached"]
        assert r["debug"] == {"data": 2, "model": 2}
        assert r["production_refused"]


def test_backend_rule_refuses_nccl_without_cards():
    assert mesh_lib.pick_backend("cpu", 4) == "gloo"
    assert mesh_lib.pick_backend("cpu", 1, "gloo") == "gloo"
    with pytest.raises(RuntimeError, match="nccl"):
        mesh_lib.pick_backend("cpu", 2, "nccl")
    with pytest.raises(ValueError, match="needs rank"):
        mesh_lib.init_distributed(device="cpu")


# ------------------------------------------------------------------ collectives
def test_hierarchical_psum_matches_flat(pool, mesh3):
    """tests/test_collectives.py::test_hierarchical_psum_matches_flat."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    jh, jfl = jax.jit(jax.shard_map(
        lambda x: (jcoll.hierarchical_psum(x, pod_axis="pod",
                                           inner_axis="data"),
                   jcoll.flat_psum(x, ("pod", "data"))),
        mesh=mesh3, in_specs=P(None, None),
        out_specs=(P(None, None), P(None, None)), check_vma=False))(x)
    res = pool.run("hier_psum", x)
    _same_on_every_rank(res, lambda r: r[0])
    h, fl, _ = res[0]
    np.testing.assert_allclose(h, fl, rtol=1e-6)
    np.testing.assert_allclose(h, 4 * x, rtol=1e-6)
    np.testing.assert_allclose(h, np.asarray(jh), rtol=1e-6)
    np.testing.assert_allclose(fl, np.asarray(jfl), rtol=1e-6)


def test_hierarchical_psum_compressed_close_and_error_carried(pool, mesh3):
    """tests/test_collectives.py::
    test_hierarchical_psum_compressed_close_and_error_carried, and the
    port's result against JAX's (the same quantization of the same
    shards)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    err0 = np.zeros((8 * 256 // 2,), np.float32)

    def f(x, e):
        out, new_e = jcoll.hierarchical_psum_compressed(
            x, e, pod_axis="pod", inner_axis="data")
        return out, new_e, jcoll.flat_psum(x, ("pod", "data"))

    jout, _, _ = jax.jit(jax.shard_map(
        f, mesh=mesh3, in_specs=(P(None, None), P(None)),
        out_specs=(P(None, None), P(None), P(None, None)),
        check_vma=False))(x, err0)
    res = pool.run("hier_psum_compressed", x, err0)
    _same_on_every_rank(res, lambda r: r[0])
    out, new_e, ref = res[0]
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < 0.03, rel                      # int8 cross-pod leg
    assert max(np.abs(r[1]).max() for r in res) > 0  # error carried
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-6,
                               atol=1e-6)


def test_counts_show_hierarchical_schedule(pool):
    """tests/test_collectives.py::test_hlo_shows_hierarchical_schedule:
    the port's collective counters in place of the HLO text — a
    reduce-scatter and an all-gather over data around one all-reduce over
    pod on the shard."""
    x = np.ones((8, 16), np.float32)
    counts = pool.run("hier_psum", x)[0][2]
    nbytes = x.nbytes
    assert counts["reduce_scatter"] == {"calls": 1, "bytes": nbytes,
                                        "staged": 0}
    assert counts["all_reduce"] == {"calls": 1, "bytes": nbytes // 2,
                                    "staged": 0}
    assert counts["all_gather"] == {"calls": 1, "bytes": nbytes // 2,
                                    "staged": 0}
    assert counts["hierarchical_psum"]["calls"] == 1


# ------------------------------------------------------------------ compress
def test_compress_decompress_matches_jax_over_three_steps():
    """optim/compress.py against JAX's, the error buffer carried over 3
    steps (a leaf that does not fill its last block, a bf16 leaf)."""
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 300), "b": (64,), "c": (16, 32)}
    jstate = pstate = None
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) * (step + 1)
             for k, s in shapes.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        pg = {k: torch.tensor(v) for k, v in g.items()}
        jstate = jstate or jcompress.init(jg)
        pstate = pstate or compress.init(pg)
        jout, jstate, jstats = jcompress.compress_decompress(jg, jstate)
        pout, pstate, pstats = compress.compress_decompress(pg, pstate)
        assert pstats == jstats
        for k in shapes:
            np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(pstate.error[k].numpy(),
                                       np.asarray(jstate.error[k]),
                                       rtol=1e-6, atol=1e-7)
    assert max(float(pstate.error[k].abs().max()) for k in shapes) > 0
    bf = {"w": torch.tensor(rng.standard_normal((4, 8)),
                            dtype=torch.bfloat16)}
    out, _, _ = compress.compress_decompress(bf, compress.init(bf))
    assert out["w"].dtype == torch.bfloat16


# ------------------------------------------------------------------ pipeline
def _jlayer(lp, h):
    y = jmp_dense(h, lp["w1"], PrecisionMode.M16)
    y = jax.nn.gelu(y)
    return h + jmp_dense(y, lp["w2"], PrecisionMode.M16)


def _params(L=8, d=16, f=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((L, d, f)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((L, f, d)) * 0.1).astype(np.float32)}


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def test_pipeline_matches_sequential(pool, jmesh):
    """tests/test_pipeline.py::test_pipeline_matches_sequential."""
    params = _params()
    x = np.random.default_rng(1).standard_normal((8, 4, 16)).astype(
        np.float32)
    jout = jax.jit(lambda p, x: jpipe.pipeline_forward(
        _jlayer, p, x, jmesh, n_micro=4))(params, x)
    res = pool.run("pipeline_fwd", params, x, 4)
    _same_on_every_rank(res, lambda r: r[0])
    out, seq, _ = res[0]
    np.testing.assert_allclose(out, seq, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=2e-5, atol=2e-5)


def test_pipeline_gradients_match(pool, jmesh):
    """tests/test_pipeline.py::test_pipeline_gradients_match: the backward
    sends each microbatch's gradient back up the stages."""
    params = _params(L=4)
    x = np.random.default_rng(2).standard_normal((4, 4, 16)).astype(
        np.float32)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jpipe.pipeline_forward(
        _jlayer, p, x, jmesh, n_micro=2) ** 2)))(params)
    res = pool.run("pipeline_grads", params, x, 2)
    for grads, seq in res:
        for k in ("w1", "w2"):
            rel = np.linalg.norm(grads[k] - seq[k]) / (
                np.linalg.norm(seq[k]) + 1e-12)
            assert rel < 1e-4, (k, rel)
            relj = np.linalg.norm(grads[k] - np.asarray(jg[k])) / (
                np.linalg.norm(np.asarray(jg[k])) + 1e-12)
            assert relj < 1e-4, (k, relj)


def test_pipeline_moves_activations_point_to_point(pool):
    """tests/test_pipeline.py::test_pipeline_collectives_in_hlo: the
    counters show the wire is send / recv (JAX: collective-permute), with
    no all-gather of the batch; one broadcast hands the last stage's
    outputs to every rank."""
    params = _params()
    x = np.zeros((8, 4, 16), np.float32)
    res = pool.run("pipeline_fwd", params, x, 4)
    for s, (_, _, counts) in enumerate(res):
        assert counts["send"]["calls"] == (4 if s < WORLD - 1 else 0)
        assert counts["recv"]["calls"] == (4 if s > 0 else 0)
        assert counts["all_gather"]["calls"] == 0
        assert counts["broadcast"]["calls"] == 1


def test_bubble_fraction():
    assert pipeline.bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert pipeline.bubble_fraction(32, 4) < 0.09
    assert pipeline.bubble_fraction(4, 4) == jpipe.bubble_fraction(4, 4)


# ------------------------------------------------------------------ sharding
SHAPES = {"w_up": (16, 64), "w_down": (64, 16), "wo": (32, 16),
          "bias": (64,), "odd": (6, 7), "cache": (2, 4, 8, 2, 4)}


def _jspec(spec):
    return tuple(spec)


def test_param_shardings_and_cache_specs_match_jax(pool):
    """dist/sharding.py's rules against JAX's on a (data 2, model 2)
    mesh: Megatron column / row parallel under TP, trailing-dim FSDP, a
    non-divisible dim replicated, the cache's batch and sequence dims."""
    jm = jax.make_mesh((2, 2), ("data", "model"),
                       axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jrules = {"tp": jsh.AxisRules(jm, batch_axes=("data",), tp_enabled=True),
              "fsdp": jsh.AxisRules(jm, batch_axes=("data", "model")),
              "none": jsh.AxisRules(jm)}
    params = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    res = pool.run("shardings", SHAPES)
    for r in res:
        for tag, rules in jrules.items():
            want = {k: _jspec(v.spec) for k, v in
                    jsh.param_shardings(params, rules).items()}
            got = {k: tuple(v) for k, v in r[tag].items()}
            # JAX drops trailing None entries of a spec; compare padded
            for k in want:
                pad = (None,) * (len(got[k]) - len(want[k]))
                assert got[k] == want[k] + pad, (tag, k, got[k], want[k])
            cache = {k: v for k, v in params.items() if v.ndim >= 2}
            wc = jsh.cache_specs(cache, rules, seq_axes="model")
            for k in cache:
                w = _jspec(wc[k])
                g = tuple(r["cache_" + tag][k])
                assert g == w + (None,) * (len(g) - len(w)), (tag, k, g, w)


def test_constrain_identity_then_redistributes(pool):
    x = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    res = pool.run("constrain_dtensor", x)
    for rank, r in enumerate(res):
        assert r["plain"]
        assert r["placements"] == ["S(0)", "R"]
        np.testing.assert_array_equal(r["full"], x)
        # rank = data * 2 + model: the data coordinate picks the rows
        np.testing.assert_array_equal(r["local"], x[2 * (rank // 2):
                                                    2 * (rank // 2) + 2])


def test_elastic_restore_across_mesh_shapes(pool, tmp_path):
    """tests/test_fault_tolerance.py::test_elastic_restore_across_mesh_shapes:
    a checkpoint saved logically restores onto a 4-rank mesh under
    param_shardings; each rank's shard is its slice of the saved array,
    bitwise, and the JAX restore of the same layout agrees."""
    rng = np.random.default_rng(3)
    params = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
              "v": rng.standard_normal((6, 12)).astype(np.float32),
              "odd": rng.standard_normal((5, 3)).astype(np.float32)}
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 3, {k: torch.tensor(v) for k, v in params.items()},
              extra_meta={"data_step": 3})
    res = pool.run("elastic_restore", d, 3,
                   {k: v.shape for k, v in params.items()})
    for rank, (shards, extra) in enumerate(res):
        assert extra == {"data_step": 3}
        for k, full in params.items():
            local, placements, shape = shards[k]
            assert shape == full.shape
            if full.shape[-1] % WORLD == 0:
                n = full.shape[-1] // WORLD
                assert placements == ["S(1)"]
                np.testing.assert_array_equal(
                    local, full[:, rank * n:(rank + 1) * n])
            else:                                # non-divisible: whole
                assert placements == ["R"]
                np.testing.assert_array_equal(local, full)
    jm = jax.make_mesh((1,), ("data",),
                       axis_types=(jax.sharding.AxisType.Auto,))
    sh = {"w": NamedSharding(jm, P("data", None))}
    jd = str(tmp_path / "jckpt")
    jckpt.save(jd, 3, {"w": jnp.asarray(params["w"])})
    restored, _ = jckpt.restore(jd, 3, {"w": jnp.zeros((8, 8))},
                                shardings=sh)
    np.testing.assert_array_equal(np.asarray(restored["w"]), params["w"])
