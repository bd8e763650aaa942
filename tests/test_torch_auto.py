"""PyTorch port: AUTO, the paper's mode 1 (port of ``repro.core.auto``, the
operand analysis of ``repro.core.limbs``, the AUTO fields of the precision
context and policy, AUTO through the dispatch routes, the models and the
serving engine and scheduler), held against the JAX package on the same
numpy inputs and against its own invariants.

The port runs on the CPU (``device="cpu"``), where every kernel wrapper runs
its plain version; the JAX side runs ``pallas_interpret`` where it reaches
a Pallas kernel and its ``ref`` backend for serving, as its own tests do.
Tolerances: the operand analysis (``significant_limbs``,
``residual_scale``, ``round_to_limbs``, ``select_mode_index``) is bitwise;
an AUTO matmul is held at tests/test_kernels.py's kernel-vs-oracle
tolerance (``torch_parity``) once both packages selected the same format;
serving logits like tests/test_torch_serve.py's ``serve_default`` logits,
at the selected format's ``rel_err_bound`` of their scale (AUTO selects M16
on the SMOKE model, whose operands are full-mantissa f32: 2^-13; M16 rounds
activations to two bf16 limbs, where a last-bit f32 difference between the
frameworks can cross a rounding boundary), and token streams equal up to
the first step whose JAX top-2 margin is within that tolerance.  Inside the
port the invariants are bitwise, as the JAX suite's: an AUTO request's
scheduled stream is its solo stream, and it rides its own launch beside the
one mixed launch of the static-format requests (two launches per tick)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mp as jmp
from proptest_compat import given, settings, st
from repro.configs import paper_mpfp as jconfigs
from repro.core import auto as jauto
from repro.core import dispatch as jdispatch
from repro.core import limbs as jlimbs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import attention as jmodels
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.serve.scheduler import ScheduledRequest as JRequest
import repro_torch.mp as mp
from repro_torch import kernels
from repro_torch.configs import paper_mpfp as pconfigs
from repro_torch.core import auto as pauto
from repro_torch.core import context as pcontext
from repro_torch.core import dispatch as pdispatch
from repro_torch.core import limbs as plimbs
from repro_torch.core.limbs import dd_from_f64, prelimb_weight
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels import mp_attention as pattn
from repro_torch.kernels import mp_matmul as pkern
from repro_torch.kernels import ref as pref
from repro_torch.models import attention as pmodels
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousScheduler, \
    ScheduledRequest
from repro_torch.weights import params_from_jax
from torch_parity import assert_attention_close, assert_matmul_close

CFG_J, CFG_P = jconfigs.SMOKE, pconfigs.SMOKE
M30 = dict(name="M30", mantissa_bits=30, n_limbs=4, max_order=3)
TOLS = (2.0 ** -13, 2.0 ** -9, 2.0 ** -6, 2.0 ** -20)
M16_BOUND = mp.resolve("M16").rel_err_bound


@pytest.fixture(scope="module")
def jax_params():
    return JT.init_params(CFG_J, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


@pytest.fixture
def m30():
    """M30 in both registries (registration is idempotent)."""
    spec = dict(M30)
    name = spec.pop("name")
    jmp.register_format(name, **spec)
    return mp.register_format(name, **spec)


@pytest.fixture(autouse=True)
def _fresh_contexts():
    pcontext.reset_context()
    jmp.reset_context()
    yield
    pcontext.reset_context()
    jmp.reset_context()


def _operands(kind, seed, shape=(24, 40)):
    """Operands with a known number of significant limbs: small integers
    (1), values exact in two bf16 limbs (2), full-mantissa f32 (2 or 3),
    the same scaled far from 1, and a tensor of zeros."""
    rng = np.random.default_rng(seed)
    if kind == "ints":
        return rng.integers(-50, 50, shape).astype(np.float32)
    if kind == "two_limbs":
        x = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jlimbs.round_to_limbs(jnp.asarray(x), 2))
    if kind == "floats":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "scaled":
        return (rng.standard_normal(shape) * 2.0 ** 40).astype(np.float32)
    if kind == "near_one":
        return (1.0 + rng.uniform(2.0 ** -11, 2.0 ** -10, shape)).astype(
            np.float32)
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    raise ValueError(kind)


KINDS = ("ints", "two_limbs", "floats", "scaled", "near_one", "zeros")


def _t(x):
    return torch.from_numpy(np.array(x))


# =========================================================================
# the operand analysis, bit for bit
# =========================================================================
@pytest.mark.parametrize("max_limbs", [1, 2, 3, 5])
@pytest.mark.parametrize("tol", TOLS)
@pytest.mark.parametrize("kind", KINDS)
def test_significant_limbs_is_jax(kind, tol, max_limbs):
    x = _operands(kind, 1)
    p = plimbs.significant_limbs(_t(x), tol=tol, max_limbs=max_limbs)
    j = jlimbs.significant_limbs(jnp.asarray(x), tol=tol,
                                 max_limbs=max_limbs)
    assert p.dtype == torch.int32 and p.ndim == 0
    assert p.device == torch.device("cpu")
    assert int(p) == int(j)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**20))
def test_significant_limbs_property_is_jax(seed):
    rng = np.random.default_rng(seed)
    kind = KINDS[seed % len(KINDS)]
    x = _operands(kind, seed, (8, 16)) * np.float32(
        2.0 ** int(rng.integers(-30, 30)))
    tol = float(2.0 ** -rng.integers(2, 24))
    p = plimbs.significant_limbs(_t(x), tol=tol, max_limbs=4)
    j = jlimbs.significant_limbs(jnp.asarray(x), tol=tol, max_limbs=4)
    assert int(p) == int(j)


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_residual_scale_and_round_to_limbs_are_jax(kind, n_limbs):
    x = _operands(kind, 2)
    p = plimbs.residual_scale(_t(x), n_limbs)
    j = jlimbs.residual_scale(jnp.asarray(x), n_limbs)
    assert p.dtype == torch.float32
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        plimbs.round_to_limbs(_t(x), n_limbs).numpy(),
        np.asarray(jlimbs.round_to_limbs(jnp.asarray(x), n_limbs)))


def test_significant_limbs_detects_integers():
    """test_core.py's integer detection."""
    ints = _t(np.arange(-100, 100, dtype=np.float32).reshape(10, 20))
    assert int(plimbs.significant_limbs(ints)) == 1
    floats = _t(_operands("floats", 0, (64, 64)))
    assert int(plimbs.significant_limbs(floats)) >= 2
    assert float(plimbs.residual_scale(ints, 1)) == 0.0


def test_round_to_limbs_is_idempotent():
    x = _t(_operands("floats", 5, (32, 32)))
    r1 = plimbs.round_to_limbs(x, 2)
    assert torch.equal(plimbs.round_to_limbs(r1, 2), r1)


CANDIDATE_SETS = {
    "default": None,
    "reversed": ("M23", "M16", "M8"),
    "M23_M8": ("M23", "M8"),
    "M8_M30": ("M8", "M30"),
    "M52_M36_M16": ("M52", "M36", "M16"),
    "one": ("M16",),
}


@pytest.mark.parametrize("tol", TOLS[:3])
@pytest.mark.parametrize("cands", CANDIDATE_SETS.values(),
                         ids=CANDIDATE_SETS.keys())
@pytest.mark.parametrize("kinds", [("ints", "ints"), ("ints", "floats"),
                                   ("two_limbs", "ints"),
                                   ("near_one", "near_one"),
                                   ("floats", "scaled")], ids="-".join)
def test_select_mode_index_is_jax(m30, kinds, cands, tol):
    """The controller's index (into the caller's candidates) on the same
    operands, candidate sets and tolerances, custom formats included."""
    a, b = _operands(kinds[0], 3, (16, 24)), _operands(kinds[1], 4, (24, 8))
    p = pauto.select_mode_index(_t(a), _t(b), cands, tol=tol)
    j = jauto.select_mode_index(jnp.asarray(a), jnp.asarray(b), cands,
                                tol=tol)
    assert p.dtype == torch.int32 and p.ndim == 0
    assert int(p) == int(j)
    rp = pauto.auto_report(_t(a), _t(b), cands, tol=tol)
    rj = jauto.auto_report(jnp.asarray(a), jnp.asarray(b), cands, tol=tol)
    assert rp["selected_format"] == rj["selected_format"]
    for key in ("sig_limbs_a", "sig_limbs_b", "residual_a_1limb",
                "residual_b_1limb", "mode_bits", "tol"):
        assert rp[key] == rj[key], key


# =========================================================================
# the controller (test_core.py, test_mp_api.py)
# =========================================================================
def test_auto_mode_selects_cheap_for_integers():
    rng = np.random.default_rng(1)
    ai = rng.integers(-50, 50, (32, 32)).astype(np.float32)
    bi = rng.integers(-50, 50, (32, 32)).astype(np.float32)
    rep = mp.auto_report(_t(ai), _t(bi))
    assert rep["selected_mode"] == mp.PrecisionMode.M8
    # integer products are exact in mode M8 (8-bit mantissa, f32 sums)
    out = mp.mp_matmul_auto(_t(ai), _t(bi))
    np.testing.assert_array_equal(out.numpy(), ai @ bi)


def test_auto_mode_escalates_for_full_mantissa():
    a, b = (_operands("floats", s, (64, 64)) for s in (2, 3))
    assert int(mp.select_mode_index(_t(a), _t(b))) >= 1


def test_auto_mode_consensus_takes_wider_operand():
    ints, floats = _operands("ints", 3, (32, 32)), _operands("floats", 4,
                                                             (32, 32))
    assert int(mp.select_mode_index(_t(ints), _t(floats))) > \
        int(mp.select_mode_index(_t(ints), _t(ints)))


def test_custom_format_in_auto_candidates(m30):
    a, b = _operands("floats", 3, (16, 32)), _operands("floats", 5, (32, 8))
    out = mp.mp_matmul_auto(_t(a), _t(b), candidates=("M8", m30))
    gold = pref.matmul_golden_f64(a, b)
    rel = np.linalg.norm(out.numpy() - gold) / np.linalg.norm(gold)
    assert rel < m30.rel_err_bound


def test_auto_name_is_reserved():
    with pytest.raises(ValueError, match="reserved"):
        mp.register_format("AUTO", mantissa_bits=16, n_limbs=2)
    with pytest.raises(ValueError, match="reserved"):
        mp.register_format("auto", mantissa_bits=16, n_limbs=2)


def test_auto_cannot_be_its_own_candidate():
    with pytest.raises(ValueError):
        mp.configure(auto_candidates=(mp.AUTO, "M16"))
    with pytest.raises(ValueError):
        with mp.context(auto_candidates=(mp.AUTO,)):
            pass
    assert mp.current_context().auto_candidates == \
        mp.DEFAULT_AUTO_CANDIDATES == jmp.DEFAULT_AUTO_CANDIDATES


def test_validate_rejects_degenerate_configs():
    with pytest.raises(ValueError):
        mp.configure(auto_candidates=())
    with pytest.raises(ValueError):
        mp.configure(backend="")
    with pytest.raises(KeyError):
        mp.configure(auto_candidates=("M99",))
    assert mp.current_context().auto_tol == 2.0 ** -13


def test_auto_candidate_order_does_not_change_choice():
    ones = torch.ones((16, 16))
    idx = int(mp.select_mode_index(ones, ones, candidates=("M23", "M8")))
    assert ("M23", "M8")[idx] == "M8"
    rep = mp.auto_report(ones, ones, candidates=("M23", "M8"))
    assert rep["selected_format"] == "M8"
    x = _t(_operands("floats", 13, (16, 16)))
    idx2 = int(mp.select_mode_index(x, x, candidates=("M23", "M8")))
    assert ("M23", "M8")[idx2] == "M23"


def test_context_auto_candidates_drive_auto_mode(m30):
    a, b = _operands("floats", 11, (16, 32)), _operands("floats", 12, (32, 8))
    gold = pref.matmul_golden_f64(a, b)

    def rel(out):
        return np.linalg.norm(out.numpy() - gold) / np.linalg.norm(gold)

    with mp.context(auto_candidates=("M8", "M30")):
        assert rel(mp.mp_matmul(_t(a), _t(b), mp.AUTO)) < m30.rel_err_bound
    with mp.context(auto_candidates=("M8", "M30"), auto_tol=2.0 ** -2):
        assert rel(mp.mp_matmul(_t(a), _t(b), mp.AUTO)) > m30.rel_err_bound


def test_auto_report_honors_tol():
    x = _t(_operands("near_one", 7, (32, 32)))
    strict = mp.auto_report(x, x)
    loose = mp.auto_report(x, x, tol=2.0 ** -6)
    assert strict["sig_limbs_a"] == 2 and loose["sig_limbs_a"] == 1
    assert loose["tol"] == 2.0 ** -6
    assert strict["selected_mode"] != loose["selected_mode"]
    assert loose["selected_format"] == "M8"


# =========================================================================
# AUTO matmuls: one host read, one branch, the JAX result
# =========================================================================
@pytest.mark.parametrize("kinds", [("ints", "ints"), ("floats", "floats"),
                                   ("ints", "floats")], ids="-".join)
@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
def test_auto_matmul_matches_jax(kinds, batched):
    """mp_matmul(AUTO) against JAX's (lax.switch over interpret-mode
    kernels): one read of the index back to the host, then exactly one
    launch of the selected format's kernel."""
    shape_a = (2, 3, 16, 24) if batched else (16, 24)
    shape_b = (2, 3, 24, 8) if batched else (24, 8)
    a, b = _operands(kinds[0], 8, shape_a), _operands(kinds[1], 9, shape_b)
    kernels.reset_launch_counts()
    p = mp.mp_matmul(_t(a), _t(b), "AUTO")
    assert pauto.mp_matmul_auto.host_reads == 1
    assert sum(kernels.plain_call_counts().values()) == 1
    assert pkern.mp_fused_matmul.plain_calls == 1
    j = jmp.mp_matmul(jnp.asarray(a), jnp.asarray(b), "AUTO",
                      backend="pallas_interpret")
    assert_matmul_close(p, np.asarray(j), pref.matmul_golden_f64(a, b))
    # the ref backend selects the same format and runs the oracle
    r = mp.mp_matmul(_t(a), _t(b), "AUTO", backend="ref")
    assert_matmul_close(r, np.asarray(j), pref.matmul_golden_f64(a, b))


def test_auto_rejects_prelimbed_and_dd_operands():
    """test_fused_proj.py's: AUTO analyzes raw values; a limb stack or a
    DD pair is refused up front."""
    x = torch.ones((4, 8))
    pw = prelimb_weight(torch.ones((8, 16)), 2)
    with pytest.raises(TypeError):
        mp.mp_matmul(x, pw, "AUTO")
    d = dd_from_f64(np.ones((8, 16)), device="cpu")
    with pytest.raises(TypeError):
        mp.mp_matmul(x, d, "AUTO")


def test_auto_fused_proj_runs_per_branch(params):
    """Under AUTO a projection group runs per-branch AUTO matmuls (one host
    read each) with the shared epilogue."""
    x = _t(_operands("floats", 21, (6, CFG_P.d_model)))
    lp = params["layers"][0]["mlp"]
    kernels.reset_launch_counts()
    out = mp.mp_swiglu(x, lp["w_gate"], lp["w_up"], "AUTO")
    assert pauto.mp_matmul_auto.host_reads == 2
    assert pkern.mp_fused_proj.plain_calls == 0
    g, u = (mp.mp_matmul(x, w, "AUTO") for w in (lp["w_gate"], lp["w_up"]))
    assert torch.equal(out, pref.silu(g) * u)


def test_mode_flops_is_jax():
    for m in ("M8", "M16", "M23", "M36", "M52"):
        assert mp.mode_flops(m, 3, 5, 7) == jmp.mode_flops(m, 3, 5, 7)


def test_facade_has_the_jax_names_the_port_has():
    """Every name ``repro.mp`` exports is in ``repro_torch.mp`` but the
    ones its docstring lists as not ported yet."""
    not_yet = set()
    jnames = {n for n in dir(jmp) if not n.startswith("_")
              and not isinstance(getattr(jmp, n), type(jmp))}
    missing = {n for n in jnames - not_yet if not hasattr(mp, n)}
    assert not missing, missing
    assert all(n in (mp.__doc__ or "") for n in not_yet)
    # the backend registry and the sharded backend are the port's now
    for n in ("pin_backend", "register_backend", "unregister_backend"):
        assert hasattr(mp, n) and n in (mp.__doc__ or ""), n
    assert "sharded" in mp.available_backends()


def test_auto_policy_is_jax():
    p, j = PrecisionPolicy.auto(), JPolicy.auto()
    assert PrecisionPolicy.from_json(j.to_json()) == p
    assert mp.get_policy("auto") == p
    for cls in ("qkv", "attn_qk", "attn_pv", "attn_out", "ffn", "lm_head"):
        pm, jm = p.mode(cls), j.mode(cls)
        assert str(getattr(pm, "name", pm)) == str(getattr(jm, "name", jm))
    assert p.mode("lm_head").name == "M23"   # the built-in default


# =========================================================================
# attention under AUTO (test_mp_attention.py)
# =========================================================================
def _qkv(seed, B=2, S=16, T=None, H=2, Dh=16):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, Dh), (B, T, H, Dh), (B, T, H, Dh))]


def test_auto_format_raises_in_mp_attention():
    q, k, v = (_t(x) for x in _qkv(0, S=8))
    with pytest.raises(ValueError, match="AUTO"):
        mp.mp_attention(q, k, v, "AUTO")


def test_auto_policy_falls_back_to_chunk_scan():
    q, k, v = (_t(x) for x in _qkv(2))
    pol = PrecisionPolicy.auto()
    kernels.reset_launch_counts()
    a = pmodels._self_attention(q, k, v, pol, causal=True, q_chunk=16,
                                kv_chunk=16)
    assert pattn.mp_flash_attention.plain_calls == 0
    b = pmodels.chunked_attention(q, k, v, pol, causal=True, q_chunk=16,
                                  kv_chunk=16)
    assert torch.equal(a, b)
    j = jmodels.chunked_attention(*(jnp.asarray(x) for x in _qkv(2)),
                                  JPolicy.auto(), causal=True, q_chunk=16,
                                  kv_chunk=16)
    assert_attention_close(a, np.asarray(j))


def test_decode_auto_policy_routes():
    q, k, v = _qkv(9, B=1, S=1, T=16, H=2, Dh=16)
    out = pdispatch.masked_decode_attention(
        _t(q), _t(k), _t(v), torch.tensor([9], dtype=torch.int32), "AUTO",
        "AUTO")
    assert out.shape == q.shape and torch.isfinite(out).all()
    j = jdispatch.masked_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray([9], jnp.int32), "AUTO", "AUTO")
    assert_attention_close(out, np.asarray(j))


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_paged_auto_takes_the_gather(backend):
    """AUTO never reaches the static-format paged kernel: the gather and the
    masked einsums run AUTO through mp_matmul on every backend."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 1, 2, 16)).astype(np.float32)
    kp = rng.standard_normal((4, 8, 2, 16)).astype(np.float32)
    vp = rng.standard_normal((4, 8, 2, 16)).astype(np.float32)
    table = np.asarray([[1, 2]], np.int32)
    lengths = np.asarray([11], np.int32)
    kernels.reset_launch_counts()
    out = pdispatch.dispatch_paged_attention(
        _t(q), _t(kp), _t(vp), _t(table), _t(lengths), "AUTO", "AUTO",
        backend=backend)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert pattn.mp_paged_attention.plain_calls == 0
    assert pauto.mp_matmul_auto.host_reads == 2
    j = jdispatch.dispatch_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), "AUTO", "AUTO", backend="pallas_interpret")
    assert_attention_close(out, np.asarray(j))


# =========================================================================
# serving under AUTO (test_substrate.py, test_serve_scheduler.py,
# test_mixed_decode.py)
# =========================================================================
def _engine(params, policy=None, backend=None, max_batch=4):
    return ServeEngine(CFG_P, params, max_batch=max_batch, max_seq=64,
                       policy=policy or PrecisionPolicy.serve_default(),
                       matmul_backend=backend, device="cpu")


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG_P.vocab, size=s).astype(np.int32)
            for s in sizes]


def test_serve_engine_auto_policy(params):
    """AUTO generate skips pre-limbing and runs one AUTO call per
    contraction: QKV (3), wo, gate, up, w_down, QK and PV per layer, on
    the prefill and on every decode step; lm_head stays M23."""
    eng = _engine(params, policy=PrecisionPolicy.auto(), max_batch=2)
    assert eng.prelimb_cache_misses == 0
    kernels.reset_launch_counts()
    outs = eng.generate([np.asarray([1, 2, 3], np.int32)], max_new=3)
    assert len(outs[0]) == 3 and all(0 <= t < CFG_P.vocab for t in outs[0])
    per_pass = 9 * CFG_P.n_layers
    assert pauto.mp_matmul_auto.host_reads == per_pass * (1 + 3)
    calls = kernels.plain_call_counts()
    assert calls["mp_fused_matmul"] == (per_pass + 1) * (1 + 3)
    assert calls["mp_decompose"] == calls["mp_prelimbed_matmul"] == 0


def test_auto_generate_logits_and_tokens_match_jax(jax_params, params):
    """Prefill and teacher-forced decode logits of the two engines under
    AUTO, then the token streams wherever the JAX margins allow."""
    je = JEngine(CFG_J, jax_params, max_batch=2, max_seq=48,
                 policy=JPolicy.auto(), matmul_backend="ref",
                 prelimb_weights=False)
    pe = _engine(params, policy=PrecisionPolicy.auto(), max_batch=2)
    prompts = [np.arange(1, 14, dtype=np.int32),
               np.asarray([5, 6, 7, 8, 9], np.int32)]
    toks = pe.pad_prompts(prompts)
    jc = JT.make_cache(CFG_J, 2, 48, dtype=jnp.float32)
    jl, jc = je._prefill(je.params, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jc)
    pl, pc = pe.prefill(toks, pe.make_cache())
    jl, pl = np.asarray(jl), pl.numpy()
    scale = np.abs(jl).max()
    np.testing.assert_allclose(pl, jl, rtol=0, atol=M16_BOUND * scale)
    max_new = 5
    j_out = je.generate(prompts, max_new=max_new)
    p_out = pe.generate(prompts, max_new=max_new)
    margins, logits = [], jl[:, -1]
    for step in range(max_new):
        top2 = np.sort(logits, -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = np.asarray([o[step] for o in j_out], np.int32)[:, None]
        out, jc = je._decode(je.params, jc, jnp.asarray(tok))
        pout, pc = pe.decode(pc, torch.as_tensor(tok, dtype=torch.long))
        logits = np.asarray(out)[:, -1]
        np.testing.assert_allclose(pout.numpy()[:, -1], logits, rtol=0,
                                   atol=M16_BOUND * np.abs(logits).max())
    compared = 0
    for i in range(len(prompts)):
        for step in range(max_new):
            if margins[step][i] <= M16_BOUND * scale:
                break
            assert p_out[i][step] == j_out[i][step], (i, step)
            compared += 1
    assert compared > 0


def test_auto_mode_request_schedules(params):
    """test_serve_scheduler.py's: an AUTO per-request policy schedules and
    matches the solo AUTO run bit for bit."""
    auto = PrecisionPolicy.auto()
    p = _prompts(7, [4])[0]
    solo = _engine(params, policy=auto).generate([p], max_new=3)[0]
    sched = ContinuousScheduler(_engine(params), n_blocks=16, block_size=8)
    done = sched.run([ScheduledRequest(rid=0, prompt=p, max_new=3,
                                       policy=auto)])
    assert done[0].out == solo


def test_auto_requests_still_bucket_apart(params):
    """test_mixed_decode.py's: the AUTO request rides its own launch while
    the static-format requests share one mixed launch (two launches per
    tick), and its tokens are its solo run's."""
    prompts = _prompts(24, [4, 5, 3])
    sched = ContinuousScheduler(_engine(params, backend="ref",
                                        max_batch=8),
                                n_blocks=48, block_size=8)
    reqs = [ScheduledRequest(rid=0, prompt=prompts[0], max_new=3, mode="M8"),
            ScheduledRequest(rid=1, prompt=prompts[1], max_new=3,
                             mode="M16"),
            ScheduledRequest(rid=2, prompt=prompts[2], max_new=3,
                             policy=PrecisionPolicy.auto())]
    solo = _engine(params, policy=PrecisionPolicy.auto(),
                   max_batch=8).generate([prompts[2]], max_new=3)[0]
    got = {r.rid: r.out for r in sched.run(reqs)}
    assert got[2] == solo
    assert sched.stats()["launches_per_tick"] == 2.0


def test_mixed_plus_auto_tick_on_the_kernel_route(params):
    """The same traffic on the ``cuda`` route (plain versions here): one
    mixed-lane launch beside one AUTO bucket per tick, the AUTO request ==
    its solo run, the static requests == theirs."""
    prompts = _prompts(25, [4, 6, 5])
    modes = ("M8", "M23", None)
    auto = PrecisionPolicy.auto()

    def req(i, arrival=0):
        return ScheduledRequest(rid=i, prompt=prompts[i], max_new=4,
                                mode=modes[i], arrival=arrival,
                                policy=auto if modes[i] is None else None)

    eng = _engine(params, max_batch=8)
    kernels.reset_launch_counts()
    sched = ContinuousScheduler(eng, n_blocks=48, block_size=8)
    got = {r.rid: r.out for r in sched.run([req(i) for i in range(3)])}
    assert sched.stats()["launches_per_tick"] == 2.0
    calls = kernels.plain_call_counts()
    assert calls["mp_mixed_prelimbed_matmul"] > 0
    assert calls["mp_paged_attention"] == 0  # AUTO takes the gather
    assert pauto.mp_matmul_auto.host_reads > 0
    for i in range(3):
        solo = ContinuousScheduler(eng, n_blocks=48, block_size=8).run(
            [req(i)])[0].out
        assert got[i] == solo, modes[i]


def test_auto_scheduler_streams_match_jax_where_margins_allow(jax_params,
                                                              params):
    """Both packages' schedulers on AUTO requests: streams agree token for
    token up to the first near-tie of the JAX logits."""
    je = JEngine(CFG_J, jax_params, max_batch=4, max_seq=64,
                 policy=JPolicy.auto(), matmul_backend="ref",
                 prelimb_weights=False)
    prompts = _prompts(26, [5, 3])
    jdone = JScheduler(je, n_blocks=32, block_size=8).run(
        [JRequest(rid=i, prompt=p, max_new=4, policy=JPolicy.auto())
         for i, p in enumerate(prompts)])
    pdone = ContinuousScheduler(_engine(params), n_blocks=32,
                                block_size=8).run(
        [ScheduledRequest(rid=i, prompt=p, max_new=4,
                          policy=PrecisionPolicy.auto())
         for i, p in enumerate(prompts)])
    jout = {r.rid: r.out for r in jdone}
    pout = {r.rid: r.out for r in pdone}
    solo = [je.generate([p], max_new=4)[0] for p in prompts]
    assert [jout[i] for i in range(2)] == solo
    assert [pout[i] for i in range(2)] == \
        [_engine(params, policy=PrecisionPolicy.auto()).generate(
            [p], max_new=4)[0] for p in prompts]
    # the JAX streams' margins, from its solo AUTO engine
    compared = 0
    for i, p in enumerate(prompts):
        toks = np.zeros((4, len(p)), np.int32)  # JAX generate's batch
        toks[0] = p
        jc = JT.make_cache(CFG_J, 4, 64, dtype=jnp.float32)
        jl, jc = je._prefill(je.params, {"tokens": jnp.asarray(toks)}, jc)
        logits = np.asarray(jl)[0, -1]
        tol = M16_BOUND * np.abs(logits).max()
        for step in range(4):
            top2 = np.sort(logits)[-2:]
            if top2[1] - top2[0] <= tol:
                break
            assert pout[i][step] == jout[i][step], (i, step)
            compared += 1
            tok = np.zeros((4, 1), np.int32)
            tok[0, 0] = jout[i][step]
            out, jc = je._decode(je.params, jc, jnp.asarray(tok))
            logits = np.asarray(out)[0, -1]
    assert compared > 0


def test_default_candidates_alias_equals_jax():
    """``repro_torch.core.auto.DEFAULT_CANDIDATES`` is the JAX package's
    back-compat alias of the default AUTO candidate set: the same modes in
    the same order, and the context's default."""
    from repro_torch.core import auto as pauto
    from repro_torch.core.context import DEFAULT_AUTO_CANDIDATES
    from repro_torch.core.formats import resolve

    assert pauto.DEFAULT_CANDIDATES is DEFAULT_AUTO_CANDIDATES
    assert [resolve(m).name for m in pauto.DEFAULT_CANDIDATES] == \
        [resolve(m).name for m in jauto.DEFAULT_CANDIDATES]
    assert [m.name for m in pauto.DEFAULT_CANDIDATES] == \
        [m.name for m in jauto.DEFAULT_CANDIDATES]
