"""The port's ``sharded`` backend against the JAX package: the K-sharded
matmul (parity per mode, ragged K, gradients, the local fallbacks, the
all-reduce bytes per mode, partials plus combine), the registry, the
context's mesh, sequence-parallel decode attention, and the serving and
training paths pinned to ``sharded``.  The JAX side runs in this process on
its 8 fake CPU devices; the port's in 4 gloo ranks started once for the
module (tests/torch_dist_pool.py).  On CPU tensors the partials kernel's
wrapper runs its plain version.

Tolerances: each backend within the format's error bound of the float64
golden, and the two packages within it of each other (the K partition sums
the per-order partials in another order than JAX's psum); against the
port's own oracle, the parity contract's rtol 2e-6 (ROADMAP.md) on the
relative error norm; sequence-parallel decode at tests/test_fleet.py's
TOLS; bitwise within the port (across ranks, and each local fallback
against the ``cuda`` route)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro_torch.mp as mp
from repro.configs import paper_mpfp as jconfigs
from repro.core import PrecisionMode, mp_matmul as jmp_matmul
from repro.core.dispatch import masked_decode_attention as jmasked
from repro.core.modes import MODE_TABLE, STATIC_MODES
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.core import dispatch
from repro_torch.core.formats import resolve
from repro_torch.kernels import mp_matmul as kern
from repro_torch.kernels import ref
from torch_dist_pool import RankPool

WORLD = 4
TOLS = {"M8": 5e-3, "M16": 1e-4, "M23": 1e-5}   # tests/test_fleet.py


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.close()


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(out, gold):
    return float(np.linalg.norm(np.asarray(out, np.float64) - gold)
                 / max(np.linalg.norm(gold), 1e-30))


def _same_on_every_rank(results, pick):
    first = pick(results[0])
    for r in results[1:]:
        got = pick(r)
        if isinstance(first, dict):
            for k in first:
                np.testing.assert_array_equal(got[k], first[k])
        else:
            np.testing.assert_array_equal(got, first)


# ------------------------------------------------------------------ parity
@pytest.fixture(scope="module")
def parity(pool):
    rng = np.random.default_rng(0)
    a, b = _rand(rng, (96, 200)), _rand(rng, (200, 128))
    res = pool.run("sharded_matmul", a, b, [m.name for m in STATIC_MODES])
    _same_on_every_rank(res, lambda r: r[0])
    return a, b, res[0]


@pytest.mark.parametrize("mode", STATIC_MODES)
def test_backend_parity_per_mode(parity, mode):
    """tests/test_dispatch.py::test_backend_parity_per_mode: the port's
    sharded result within the mode's bound of the f64 golden and of JAX's
    oracle (which JAX's sharded result is held within the bound of);
    against the port's oracle at rtol 2e-6."""
    a, b, (outs, _) = parity
    gold = ref.matmul_golden_f64(torch.tensor(a), torch.tensor(b))
    bound = float(MODE_TABLE[mode].rel_err_bound)
    got = outs[mode.name]
    assert _rel(got, gold) < bound, mode
    jgot = np.asarray(jmp_matmul(jnp.asarray(a), jnp.asarray(b), mode,
                                 backend="ref"), np.float64)
    assert _rel(got, jgot) < bound, mode
    want = ref.mp_matmul_ref(torch.tensor(a), torch.tensor(b), mode.name)
    assert _rel(got, want.double().numpy()) < 2e-6, mode


def test_sharded_collective_bytes_scale_with_mode(parity):
    """tests/test_dispatch.py::test_sharded_collective_bytes_scale_with_mode
    with the port's counters: ONE all-reduce per matmul of exactly
    n_orders x M x N x 4 bytes, so M23 moves 3x M8's bytes."""
    a, b, (_, counts) = parity
    M, N = a.shape[0], b.shape[1]
    for mode in STATIC_MODES:
        assert counts[mode.name] == {
            "calls": 1, "bytes": resolve(mode.name).n_orders * M * N * 4,
            "staged": 0}, mode
    assert counts["M23"]["bytes"] == 3 * counts["M8"]["bytes"]


def test_sharded_runs_on_multi_rank_mesh_ragged_k(pool):
    """tests/test_dispatch.py::test_sharded_runs_on_multi_device_mesh, at a
    K that does not divide the 4 ranks (JAX's zero-padded slices)."""
    rng = np.random.default_rng(1)
    for K in (200, 203, 3):
        a, b = _rand(rng, (64, K)), _rand(rng, (K, 64))
        res = pool.run("sharded_matmul", a, b, ["M16"])
        _same_on_every_rank(res, lambda r: r[0]["M16"])
        got = res[0][0]["M16"]
        want = ref.mp_matmul_ref(torch.tensor(a), torch.tensor(b), "M16")
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)
        jwant = jmp_matmul(jnp.asarray(a), jnp.asarray(b), PrecisionMode.M16,
                           backend="ref")
        np.testing.assert_allclose(got, np.asarray(jwant), rtol=1e-5,
                                   atol=1e-5)


def test_sharded_gradients_flow(pool):
    """tests/test_dispatch.py::test_sharded_gradients_flow: the forward, the
    dgrad (K-sharded over the forward's N) and, for a 2-D activation, the
    wgrad (a dispatched A^T @ g, K-sharded over M, as in JAX) each one
    all-reduce; against the cuda route and JAX's gradients on its oracle
    (which JAX's sharded gradients are held to at the same tolerance)."""
    rng = np.random.default_rng(2)
    a, b = _rand(rng, (32, 64)), _rand(rng, (64, 32))
    res = pool.run("sharded_grads", a, b, "M16", "M23")
    _same_on_every_rank(res, lambda r: r["sharded"][0])
    _same_on_every_rank(res, lambda r: r["sharded"][1])
    out = res[0]
    assert out["sharded"][2] == 3 and out["cuda"][2] == 0
    jga, jgb = jax.grad(lambda a, b: jnp.sum(jmp_matmul(
        a, b, PrecisionMode.M16, backend="ref",
        bwd_mode=PrecisionMode.M23) ** 2), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    for i, jg in enumerate((jga, jgb)):
        np.testing.assert_allclose(out["sharded"][i], out["cuda"][i],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out["sharded"][i], np.asarray(jg),
                                   rtol=2e-4, atol=2e-4)


def test_sharded_falls_back_locally(pool):
    """tests/test_dispatch.py::test_sharded_falls_back_inside_shard_map and
    ::test_sharded_batched_and_dd_fall_back_cleanly, and
    tests/test_fused_proj.py's sharded pre-limbed case: inside an owned
    scope, with a batched b, DD or pre-limbed operands the backend computes
    locally — bitwise the cuda route, no collective — and agrees with JAX's
    oracle."""
    rng = np.random.default_rng(7)
    a, b = _rand(rng, (16, 64)), _rand(rng, (64, 16))
    a3, b3 = _rand(rng, (3, 16, 64)), _rand(rng, (3, 64, 16))
    x, w = _rand(rng, (2, 6, 64)), _rand(rng, (64, 48))
    res = pool.run("sharded_fallbacks", a, b, a3, b3, x, w)
    for got, local, calls in res:
        assert calls == 0
        for k in got:
            np.testing.assert_array_equal(got[k], local[k])
    got = res[0][0]
    np.testing.assert_allclose(got["owned"], np.asarray(jmp_matmul(
        jnp.asarray(a), jnp.asarray(b), PrecisionMode.M16, backend="ref")),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["batched"], np.asarray(jmp_matmul(
        jnp.asarray(a3), jnp.asarray(b3), PrecisionMode.M16,
        backend="ref")), rtol=1e-5, atol=1e-5)
    gold = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    assert _rel(got["dd"], gold) < float(MODE_TABLE[PrecisionMode.M52].rel_err_bound)
    want = np.asarray(jmp_matmul(jnp.asarray(x), jnp.asarray(w),
                                 PrecisionMode.M23, backend="ref"))
    assert _rel(got["prelimbed"], want) < resolve("M23").rel_err_bound


@pytest.mark.parametrize("mode", STATIC_MODES)
def test_partials_match_ref_combine(mode):
    """tests/test_dispatch.py::test_partials_match_ref_combine, plus the
    CPU form of the card's gate: combine_partials of the partials kernel's
    plain stack is the fused kernel's plain result bitwise, and the plain
    stack equals ref.mp_matmul_partials."""
    rng = np.random.default_rng(5)
    a, b = _rand(rng, (48, 96)), _rand(rng, (96, 32))
    ta, tb = torch.tensor(a), torch.tensor(b)
    stacked = ref.mp_matmul_partials(ta, tb, mode.name)
    assert stacked.shape[0] == MODE_TABLE[mode].n_orders
    out = ref.combine_partials(stacked, mode.name)
    gold = ref.matmul_golden_f64(ta, tb)
    assert _rel(out.numpy(), gold) < float(MODE_TABLE[mode].rel_err_bound)
    jst = jref.mp_matmul_partials(jnp.asarray(a), jnp.asarray(b), mode)
    np.testing.assert_allclose(stacked.numpy(), np.asarray(jst), rtol=2e-6,
                               atol=2e-6 * float(np.abs(jst).max()))
    plain = kern.mp_fused_matmul_partials(ta, tb, mode.name)
    assert torch.equal(plain, stacked)
    assert torch.equal(ref.combine_partials(plain, mode.name),
                       kern.mp_fused_matmul(ta, tb, mode.name))


# ------------------------------------------------------------------ registry
def test_registry_routing_and_errors():
    """tests/test_dispatch.py::test_registry_routing_and_errors and the
    deprecated shims (tests/test_dispatch.py::
    test_use_backend_context_restores_default)."""
    assert {"cuda", "ref", "sharded"} <= set(mp.available_backends())
    with pytest.raises(ValueError):
        dispatch.dispatch(torch.zeros(2, 2), torch.zeros(2, 2), "M8",
                          backend="nope")
    with pytest.raises(ValueError):
        mp.register_backend("ref", lambda *a: None)
    with pytest.raises(ValueError):
        mp.unregister_backend("sharded")
    calls = []

    def custom(a, b, fmt):
        calls.append(fmt)  # backends receive the resolved MPFormat
        return ref.mp_matmul_ref(a, b, fmt)

    mp.register_backend("custom_test", custom)
    try:
        out = mp.mp_matmul(torch.ones(4, 8), torch.ones(8, 4), "M8",
                           backend="custom_test")
        assert [f.name for f in calls] == ["M8"]
        assert torch.equal(out, torch.full((4, 4), 8.0))
        q, k = mp.mp_fused_proj(torch.ones(4, 8), (torch.ones(8, 4),) * 2,
                                "M8", backend="custom_test")
        assert len(calls) == 3 and torch.equal(q, k)
        pinned = mp.pin_backend(lambda: mp.current_context().backend,
                                "custom_test")
        assert pinned() == "custom_test"
    finally:
        mp.unregister_backend("custom_test")
    before = dispatch.get_default_backend()
    with pytest.warns(DeprecationWarning):
        with dispatch.use_backend("sharded"):
            assert dispatch.get_default_backend() == "sharded"
    assert dispatch.get_default_backend() == before
    with pytest.raises(ValueError):
        with pytest.warns(DeprecationWarning):
            with dispatch.use_backend("nope"):
                pass


def test_sharded_without_a_process_group_computes_locally():
    """One process, no group: the sharded backend is a world of one rank
    and computes on the cuda route, bitwise."""
    rng = np.random.default_rng(9)
    a, b = torch.tensor(_rand(rng, (8, 40))), torch.tensor(_rand(rng, (40, 8)))
    assert torch.equal(mp.mp_matmul(a, b, "M16", backend="sharded"),
                       mp.mp_matmul(a, b, "M16", backend="cuda"))


def test_sharded_context_mesh_axis_handling(pool):
    """tests/test_mp_api.py::test_sharded_context_mesh_axis_handling: a 1-D
    context mesh under any axis name shards; a 2-D mesh without a 'data'
    axis raises instead of silently computing on one rank."""
    rng = np.random.default_rng(12)
    a, b = _rand(rng, (16, 64)), _rand(rng, (64, 16))
    want = ref.mp_matmul_ref(torch.tensor(a), torch.tensor(b), "M16")
    for got, calls, err in pool.run("context_mesh", a, b):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)
        assert calls == 1
        assert "1-D mesh" in err


# ------------------------------------------------------------------ sp decode
def _qkv(seed=0, B=2, T=21, H=4, Dh=8):
    # T = 21 does not divide the 4 ranks: exercises the zero-pad
    rng = np.random.default_rng(seed)
    return (_rand(rng, (B, 1, H, Dh)), _rand(rng, (B, T, H, Dh)),
            _rand(rng, (B, T, H, Dh)))


@pytest.mark.parametrize("mode", ["M8", "M16", "M23"])
def test_sp_decode_matches_single_rank_einsum(pool, mode):
    """tests/test_fleet.py::TestSequenceParallelDecode::
    test_matches_single_device_einsum: against JAX's single-device masked
    path and the port's; three all-reduces (max, denominator, P @ V)."""
    q, k, v = _qkv()
    ln = np.asarray([21, 13], np.int32)
    res = pool.run("sp_decode", q, k, v, ln, mode)
    _same_on_every_rank(res, lambda r: r[0])
    got, twice, counts = res[0]
    want = jmasked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(ln), mode, backend="ref")
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOLS[mode],
                               atol=TOLS[mode])
    local = dispatch.masked_decode_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(ln),
        mode, backend="cuda")
    np.testing.assert_allclose(got, local.numpy(), rtol=TOLS[mode],
                               atol=TOLS[mode])
    assert counts["calls"] == 3


def test_sp_decode_masked_rows_flush_exact_zero(pool):
    """::test_masked_rows_flush_exact_zero."""
    q, k, v = _qkv(seed=1)
    ln = np.asarray([15, 0], np.int32)     # slot 1 inactive
    for out, _, _ in pool.run("sp_decode", q, k, v, ln, "M16"):
        assert np.all(out[1] == 0.0)


def test_sp_decode_repeats_bitwise(pool):
    """::test_under_jit: the port has no jit; the same call twice gives the
    same bits, within TOLS of JAX's single-device path."""
    q, k, v = _qkv(seed=2)
    ln = np.asarray([21, 7], np.int32)
    res = pool.run("sp_decode", q, k, v, ln, "M16")
    want = jmasked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(ln), "M16", backend="ref")
    for out, twice, _ in res:
        assert twice
        np.testing.assert_allclose(out, np.asarray(want), rtol=TOLS["M16"],
                                   atol=TOLS["M16"])


def test_sp_decode_routes_and_auto_falls_back(pool):
    """::test_masked_decode_attention_sharded_backend_routes,
    ::test_dispatch_attention_sharded_decode_shape and
    ::test_auto_format_falls_back."""
    q, k, v = _qkv(seed=3)
    ln = np.asarray([21, 9], np.int32)
    res = pool.run("sp_routes", q, k, v, ln)
    _same_on_every_rank(res, lambda r: r["masked"])
    r = res[0]
    assert r["n_masked"] == 3
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(
        r["masked"], np.asarray(jmasked(jq, jk, jv, jnp.asarray(ln), "M16",
                                        backend="ref")),
        rtol=TOLS["M16"], atol=TOLS["M16"])
    from repro.core.dispatch import dispatch_attention as jdispatch_attention
    T_ = k.shape[1]
    np.testing.assert_allclose(
        r["probe"], np.asarray(jdispatch_attention(
            jq, jk, jv, "M16", causal=True, q_offset=T_ - 1, backend="ref")),
        rtol=TOLS["M16"], atol=TOLS["M16"])
    np.testing.assert_array_equal(r["auto"], r["auto_local"])
    np.testing.assert_allclose(
        r["auto"], np.asarray(jmasked(jq, jk, jv, jnp.asarray(ln), "AUTO",
                                      backend="ref")),
        rtol=TOLS["M16"], atol=TOLS["M16"])


# ------------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def jax_params():
    return JT.init_params(jconfigs.SMOKE, jax.random.PRNGKey(0))


def test_engine_pins_backend_end_to_end(pool, jax_params):
    """tests/test_dispatch.py::test_engine_pins_backend_end_to_end: a
    ServeEngine built with matmul_backend="sharded" decodes through the
    multi-rank path with the default engine's tokens (and JAX's default
    engine's, which its sharded engine is held equal to), the same on every
    rank; prefill K-shards wo, w_down and
    lm_head (2 layers: 5 partials stacks), each decode step runs 3
    all-reduces per layer's attention and nothing else (pre-limbed decode
    weights compute locally)."""
    prompts = [[1, 2, 3]]
    np_params = jax.tree_util.tree_map(np.asarray, jax_params)
    res = pool.run("engine_generate", np_params, prompts, 3)
    toks, ref_toks, counts, partials = res[0]
    for r in res:
        assert r[0] == toks
    assert toks == ref_toks
    jtoks = JEngine(jconfigs.SMOKE, jax_params, max_batch=2, max_seq=48
                    ).generate(
        [np.asarray(p, np.int32) for p in prompts], max_new=3)
    assert toks == [list(map(int, t)) for t in jtoks]
    n_layers = jconfigs.SMOKE.n_layers
    prefill = 2 * n_layers + 1
    assert partials == prefill
    assert counts["calls"] == prefill + 3 * 3 * n_layers


def test_scheduler_under_sharded_matches_cuda(pool, jax_params):
    """The continuous scheduler over a sharded engine: paged decode runs
    sequence-parallel (the gather, then three all-reduces per layer), every
    rank streams the same tokens, every request finishes, and the streams
    equal the cuda engine's."""
    prompts = [[1, 2, 3, 4], [5, 6], [7, 8, 9, 10, 11]]
    np_params = jax.tree_util.tree_map(np.asarray, jax_params)
    res = pool.run("scheduler_streams", np_params, prompts, 3)
    first = res[0]["sharded"][0]
    for r in res:
        assert r["sharded"][0] == first
    assert sorted(first) == [0, 1, 2]
    assert all(len(v) == 3 for v in first.values())
    assert first == res[0]["cuda"][0]
    assert res[0]["sharded"][1] > 0 and res[0]["cuda"][1] == 0


def test_trainer_value_and_grad_under_sharded(pool, jax_params):
    """One value_and_grad of the SMOKE model under train_default: the loss
    equal across ranks and within 1e-5 relative of the cuda backend's,
    each gradient leaf within 5e-4 of its max (chip_smoke.py [train]'s
    bounds); dgrads K-sharded, so the backward all-reduces."""
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jconfigs.SMOKE.vocab, (2, 16)).astype(np.int64)
    labels = rng.integers(0, jconfigs.SMOKE.vocab, (2, 16)).astype(np.int64)
    np_params = jax.tree_util.tree_map(np.asarray, jax_params)
    res = pool.run("train_value_and_grad", np_params, toks, labels)
    loss, grads, calls = res[0]["sharded"]
    for r in res:
        assert r["sharded"][0] == loss
    cl, cg, ccalls = res[0]["cuda"]
    assert ccalls == 0 and calls > 0
    assert abs(loss - cl) <= 1e-5 * abs(cl)
    for p, g in grads.items():
        scale = max(float(np.abs(cg[p]).max()), 1e-30)
        assert float(np.abs(g - cg[p]).max()) <= 5e-4 * scale, p


# ------------------------------------------------------------------ launchers
@pytest.mark.parametrize("module,args", [
    ("repro_torch.launch.serve", ["--requests", "2", "--max-new", "3",
                                  "--backend", "sharded"]),
    ("repro_torch.launch.train", ["--steps", "2", "--batch", "2", "--seq",
                                  "16"]),
    ("repro_torch.launch.train", ["--steps", "2", "--batch", "3", "--seq",
                                  "16", "--backend", "sharded"])])
def test_launcher_under_torchrun_on_two_gloo_ranks(tmp_path, module, args):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.{serve,train}
    --device cpu``: each rank joins the group from torchrun's environment,
    rank 0 alone prints, and the run ends 0 only if every rank's tokens
    (losses) equal rank 0's.  The server runs ``--backend sharded``; the
    trainer lays a batch of 2 out on the FSDP layout (``make_rules``), and
    a batch of 3, which does not divide the ranks, runs whole on every rank
    under ``--backend sharded``."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    extra = ["--ckpt-dir", str(tmp_path / "ckpt")] \
        if module.endswith("train") else []
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", module, "--smoke", "--device", "cpu",
         *args, *extra],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    if module.endswith("serve"):
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("req")]
        assert len(lines) == 2          # rank 0's two streams, once
    else:
        fsdp = "--backend" not in args
        assert run.stdout.count("FSDP layout over 2 ranks") == int(fsdp)
        assert run.stdout.count("done: loss") == 1
        assert run.stdout.count("done: loss") == 1
