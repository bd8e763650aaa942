"""PyTorch port: the expert-parallel MoE (``models.moe.moe_forward_ep``)
against the JAX package, the cases of tests/test_moe_ep.py.

The port runs in 4 gloo ranks (tests/torch_dist_pool.py) on a (data 2,
model 2) mesh; JAX's ``moe_forward_ep`` runs in this process on a (2, 2)
mesh of 4 of its 8 fake CPU devices.  Each of the three routes — the split
route (tokens sliced over the model axis, ``all_to_all`` to the experts'
ranks and back), ``tokens_on_model`` and the replicated decode route (a
psum over the model axis) — and the capacity-drop case is held against
the port's dense oracle (tests/test_moe_ep.py's 1e-4 of the output's max)
and against JAX's output and aux (full_fp32: f32 orders only, 1e-5); the
gradients of sum(out * ct) + 0.01 aux + 1e-4 zloss against ``jax.grad``
of the same loss (5e-4 of each leaf's max, tests/test_torch_train.py's
bound).  ``_dispatch_chunk``'s buffer, keep mask and buffer index are
bitwise JAX's.  Then the MoE SMOKE model with the mesh: its loss and
gradients against the all-experts path (a capacity factor that drops
nothing), ``ServeEngine(mesh=...)``'s tokens, ``Trainer.run`` and the
checkpoint restored with its experts by shard."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as jregistry
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch.models import moe as pmoe
from torch_dist_pool import RankPool

WORLD = 4
POLICY = JPolicy.full_fp32()
GRAD_BOUND = 5e-4
ALL_TO_ALL_BYTES = 4   # dispatch_dtype float32


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


def _dims(cap=8.0, n_chunks=1):
    return dict(d_model=32, n_experts=8, top_k=2, expert_ff=48, n_shared=1,
                capacity_factor=cap, n_chunks=n_chunks)


def _params(dims_kw):
    return jmoe.init_moe_params(jax.random.PRNGKey(0),
                                jmoe.MoEDims(**dims_kw))


def _jax_ep(jmesh, params, x, dims_kw, route_kw, ct):
    dims = jmoe.MoEDims(**dims_kw)

    def loss(p, x):
        out, aux = jmoe.moe_forward_ep(p, x, dims, POLICY, jmesh, **route_kw)
        return (jnp.sum(out * ct) + 0.01 * aux["moe_aux"]
                + 1e-4 * aux["moe_zloss"]), (out, aux)

    with jmesh:
        (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
    grads = {"x": np.asarray(gx)}
    for path, g in jax.tree_util.tree_flatten_with_path(gp)[0]:
        grads["/".join(k.key for k in path)] = np.asarray(g)
    return np.asarray(out), {k: float(v) for k, v in aux.items()}, grads


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _run(pool, jmesh, x_shape, seed, dims_kw, route_kw):
    params = _params(dims_kw)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    ct = rng.standard_normal(x_shape).astype(np.float32)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    res = pool.run("moe_ep", np_params, x, dims_kw, route_kw, ct)
    jout, jaux, jgrads = _jax_ep(jmesh, params, jnp.asarray(x), dims_kw,
                                 route_kw, jnp.asarray(ct))
    for r in res[1:]:  # every rank returns the whole output and gradients
        np.testing.assert_array_equal(r["out"], res[0]["out"])
        for k in r["grads"]:
            np.testing.assert_array_equal(r["grads"][k], res[0]["grads"][k])
    r = res[0]
    assert _rel(r["out"], jout) < 1e-5
    for k in jaux:
        np.testing.assert_allclose(r["aux"][k], jaux[k], rtol=1e-5)
    assert sorted(r["grads"]) == sorted(jgrads)
    for k, g in jgrads.items():
        assert r["grads"][k].shape == g.shape, k
        assert _rel(r["grads"][k], g) < GRAD_BOUND, k
    return r


def test_ep_split_path_matches_dense_and_jax(pool, jmesh):
    dims_kw = _dims(n_chunks=2)
    r = _run(pool, jmesh, (4, 16, 32), 0, dims_kw, {})
    assert _rel(r["out"], r["dense"]) < 1e-4
    # per chunk one exchange there and one back; the backward repeats them
    T_loc = 4 * 16 // 2 // 2
    cap = math.ceil(T_loc // 2 * 2 * 8.0 / 8)
    a2a = r["fwd_counts"]["all_to_all"]
    assert a2a["calls"] == 2 * 2
    assert a2a["bytes"] == 2 * 2 * 8 * cap * 32 * ALL_TO_ALL_BYTES
    assert r["counts"]["all_to_all"]["calls"] == 2 * a2a["calls"]
    assert a2a["staged"] == 0


def test_ep_tokens_on_model_matches_dense_and_jax(pool, jmesh):
    """seq-sharded tokens: x enters pre-sharded over (data, model)."""
    r = _run(pool, jmesh, (4, 16, 32), 1, _dims(),
             {"tokens_on_model": True})
    assert _rel(r["out"], r["dense"]) < 1e-4
    assert r["fwd_counts"]["all_to_all"]["calls"] == 2


def test_ep_replicated_decode_path_matches_dense_and_jax(pool, jmesh):
    """decode-sized batch (one token per data shard, fewer than the model
    axis): the replicated route, a psum in place of the exchange."""
    r = _run(pool, jmesh, (2, 1, 32), 2, _dims(), {})
    assert _rel(r["out"], r["dense"]) < 1e-4
    assert r["fwd_counts"]["all_to_all"]["calls"] == 0


def test_capacity_drops_are_bounded_and_match_jax(pool, jmesh):
    """At capacity_factor=1.0 some assignments drop: outputs finite, the
    same drops (and so the same output) as JAX's."""
    dims_kw = _dims(cap=1.0)
    r = _run(pool, jmesh, (4, 16, 32), 3, dims_kw, {})
    assert np.isfinite(r["out"]).all() and np.isfinite(r["aux"]["moe_aux"])
    assert _rel(r["out"], r["dense"]) > 1e-4   # something was dropped


def test_dispatch_chunk_bookkeeping_is_jax_bitwise():
    """tests/test_moe_ep.py::test_dispatch_chunk_bookkeeping on the port,
    and send / keep / buf_idx bitwise JAX's, with and without drops."""
    for T, cap, seed in ((8, 4, 4), (16, 3, 5)):
        jd = jmoe.MoEDims(d_model=4, n_experts=4, top_k=2, expert_ff=8)
        pd = pmoe.MoEDims(d_model=4, n_experts=4, top_k=2, expert_ff=8)
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((T, 4)).astype(np.float32)
        top_i = rng.integers(0, 4, (T, 2)).astype(np.int32)
        top_p = np.full((T, 2), 0.5, np.float32)
        js, jk, jb = jmoe._dispatch_chunk(jnp.asarray(x), jnp.asarray(top_p),
                                          jnp.asarray(top_i), jd, cap)
        send, keep, buf_idx = pmoe._dispatch_chunk(
            torch.from_numpy(x), torch.from_numpy(top_p),
            torch.from_numpy(top_i).long(), pd, cap)
        assert send.shape == (4 * cap, 4)
        np.testing.assert_array_equal(send.numpy(), np.asarray(js))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(buf_idx.numpy(), np.asarray(jb))
        kept = buf_idx[keep].tolist()
        assert len(set(kept)) == len(kept)  # unique slots
        tok_of_flat = np.repeat(np.arange(T), 2)
        for i in torch.nonzero(keep)[:, 0].tolist():
            np.testing.assert_array_equal(send[buf_idx[i]].numpy(),
                                          x[tok_of_flat[i]])
        assert (buf_idx[~keep] == 4 * cap).all()
        assert (~keep).any() == (T * 2 > 4 * cap or cap < T)


@pytest.fixture(scope="module")
def moe_smoke():
    jcfg = jregistry.get_config("deepseek-v2-lite-16b", smoke=True)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jax.tree_util.tree_map(np.asarray, jp)


def test_moe_model_gradients_with_the_mesh_match_jax(pool, moe_smoke,
                                                     jmesh):
    """The MoE SMOKE's loss (aux and z-loss included) and every gradient
    leaf with the expert-parallel mesh against JAX's ``make_loss_fn`` with
    its (2, 2) mesh; the nll and z-loss also against the port's
    all-experts path (its capacity factor 2.0 = E / top_k drops nothing;
    the load-balance aux is a mean over the ranks' token slices there)."""
    from repro.core import context as jcontext
    from repro.train import trainer as jtrainer
    from repro_torch.weights import params_from_jax

    jcfg, np_params = moe_smoke
    assert jcfg.moe.capacity_factor * jcfg.moe.top_k >= jcfg.moe.n_experts
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (4, 9)).astype(np.int32)
    res = pool.run("moe_model_grads", np_params, toks[:, :-1], toks[:, 1:])
    for r in res[1:]:
        assert r["ep"][0] == res[0]["ep"][0]
        for k, g in r["ep"][2].items():
            np.testing.assert_array_equal(g, res[0]["ep"][2][k])
    (l_ep, x_ep, g_ep, c_ep), (_, x_d, _, _) = res[0]["ep"], res[0]["dense"]
    for k in ("nll", "moe_zloss"):
        np.testing.assert_allclose(x_ep[k], x_d[k], rtol=1e-5)
    loss_fn = jtrainer.make_loss_fn(jcfg, POLICY, jtrainer.TrainerConfig(),
                                    mesh=jmesh)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    with jmesh, jcontext.context(backend="ref"):
        (jl, jx), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, np_params), batch)
    assert abs(l_ep - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("nll", "moe_aux", "moe_zloss"):
        np.testing.assert_allclose(x_ep[k], float(jx[k]), rtol=1e-5)
    from repro_torch import tree as tree_lib

    jg = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for k, g in tree_lib.items(jg):
        g = g.numpy()
        assert _rel(g_ep[k], g) < GRAD_BOUND, k
    # one MoE layer, B 4 x S 8 tokens: 2 rows per data shard = 16 tokens,
    # 8 per model rank, one chunk: 2 exchanges forward, 2 more in remat's
    # recompute and 2 in the backward
    assert c_ep["all_to_all"]["calls"] == 6


def test_moe_engine_trainer_and_restore_with_the_mesh(pool, moe_smoke,
                                                      tmp_path):
    jcfg, np_params = moe_smoke
    prompts = [np.arange(3, 11), np.asarray([5, 6, 7, 8, 9, 10])]
    res = pool.run("moe_model_serve_train", np_params, prompts, 4,
                   str(tmp_path))
    r = res[0]
    toks_ep, c_ep = r["generate_ep"]
    toks_d, _ = r["generate_dense"]
    assert [list(t) for t in toks_ep] == [list(t) for t in toks_d]
    # the prefill's 2 x 8 tokens take the split route (one exchange there
    # and back), each decode step (1 token a data shard) the psum route
    assert c_ep["all_to_all"]["calls"] == 2
    np.testing.assert_allclose(r["train_ep"], r["train_dense"], rtol=1e-5)
    for q in res:
        local, want, shape, router, router_want = q["restore"]
        np.testing.assert_array_equal(local, want)
        np.testing.assert_array_equal(router, router_want)
        assert shape == want.shape[:0] + (jcfg.moe.n_experts,
                                          jcfg.moe.d_model,
                                          jcfg.moe.expert_ff)
