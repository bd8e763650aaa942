"""PyTorch port: two-float (DD) operands, the paper's modes 5 and 6 on
operands wider than f32 (port of ``repro.core.limbs.DD`` /
``decompose_dd``, the DD route of ``repro.kernels.ops._matmul2d_dd`` and
the Pallas ``_both_prelimbed_kernel``), held against the JAX package on the
same numpy inputs.

The port runs on the CPU, where the both-prelimbed wrapper runs its plain
version; the JAX side runs ``ops.mp_matmul_pallas(..., interpret=True)``.
Tolerances: the limb cascade of a DD pair is bitwise (the same f32 and bf16
roundings in the same order); the DD matmul against JAX at
tests/test_kernels.py's ``test_dd_high_modes`` tolerance (rtol 3e-6, atol
1e-5) and against the float64 golden below that test's bound
``8 * 2^-24 * sqrt(K)`` relative norm; inside the port the both-prelimbed
plain version is bitwise the fused plain version on stacks cut from f32
operands."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proptest_compat import given, settings, st
from repro.core import limbs as jlimbs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.core import limbs as plimbs
from repro_torch.core.formats import register_format, resolve, \
    unregister_format
from repro_torch.core.limbs import DD, dd_from_f64, dd_to_f64
from repro_torch.core.mpmatmul import mp_fused_proj, mp_matmul
from repro_torch.kernels import mp_matmul as pkern
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref

HIGH = ("M36", "M52")
BUILTINS = ("M8", "M16", "M23", "M36", "M52")


def _f64(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _jdd(x64):
    return jlimbs.dd_from_f64(x64)


def _pdd(x64):
    return dd_from_f64(x64, device="cpu")


def _limb_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _golden_bound(K):
    return 8 * 2.0 ** -24 * np.sqrt(K)


@pytest.fixture
def m30():
    fmt = register_format("M30DD", mantissa_bits=30, n_limbs=4, max_order=3)
    yield fmt
    unregister_format("M30DD")


# =========================================================================
# the DD pair and its limb cascade, bit for bit
# =========================================================================
@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**20))
def test_dd_roundtrip_property(seed):
    """test_core.py's round trip, plus the pair itself equals JAX's."""
    x64 = _f64(seed, 8, 8)
    d = _pdd(x64)
    back = dd_to_f64(d)
    assert np.max(np.abs(back - x64)) <= 2.0 ** -45 * np.max(np.abs(x64))
    j = _jdd(x64)
    np.testing.assert_array_equal(d.hi.numpy(), np.asarray(j.hi))
    np.testing.assert_array_equal(d.lo.numpy(), np.asarray(j.lo))


def _dd_cases(seed):
    """f64 inputs whose DD pairs probe the cascade: generic values over a
    wide exponent range, and exact f32 values (lo == 0; -0.0, +0.0 and a
    signed one among them)."""
    rng = np.random.default_rng(seed)
    wide = rng.standard_normal((17, 23)) * np.exp(rng.uniform(-20, 20,
                                                              (17, 23)))
    exact = rng.standard_normal((17, 23)).astype(np.float32).astype(
        np.float64)
    exact[0, :3] = (-0.0, 0.0, -1.0)
    return {"wide": wide, "exact_f32": exact}


def _numpy_decompose_dd(d: DD, n_limbs: int) -> np.ndarray:
    """``limbs.decompose_dd`` in numpy f32 and ml_dtypes bf16, which keep
    subnormals (IEEE, as PyTorch does on the CPU and the card)."""
    import ml_dtypes

    r, lo = d.hi.numpy(), d.lo.numpy()
    out = []
    for i in range(n_limbs):
        li = r.astype(ml_dtypes.bfloat16)
        out.append(li)
        r = (r - li.astype(np.float32)).astype(np.float32)
        if i == 2:
            r = (r + lo).astype(np.float32)
    return np.stack(out).view(np.int16)


@pytest.mark.parametrize("n_limbs", range(1, 8))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decompose_dd_is_bitwise_jax(seed, n_limbs):
    for kind, x64 in _dd_cases(seed).items():
        p = plimbs.decompose_dd(_pdd(x64), n_limbs)
        j = jlimbs.decompose_dd(_jdd(x64), n_limbs)
        assert p.dtype == torch.bfloat16 and p.shape == (n_limbs,) + x64.shape
        np.testing.assert_array_equal(
            _limb_bits(p), np.asarray(j).view(np.int16), err_msg=kind)
        np.testing.assert_array_equal(
            _limb_bits(p), _numpy_decompose_dd(_pdd(x64), n_limbs))


@pytest.mark.parametrize("n_limbs", [1, 3, 7])
def test_decompose_dd_of_subnormal_hi_keeps_subnormals(n_limbs):
    """hi words below 2^-126: the port keeps f32 subnormals (IEEE), bitwise
    the numpy cascade.  XLA on the CPU flushes them to zero (JAX's result
    then differs, by less than 2^-126 per limb, and in the sign of zeros)."""
    x64 = _f64(5, 17, 23) * 2.0 ** -140
    d = _pdd(x64)
    p = plimbs.decompose_dd(d, n_limbs)
    np.testing.assert_array_equal(_limb_bits(p),
                                  _numpy_decompose_dd(d, n_limbs))
    assert (d.hi != 0).any()
    j = np.asarray(jlimbs.decompose_dd(_jdd(x64), n_limbs), np.float32)
    assert np.abs(p.float().numpy() - j).max() < 2.0 ** -126


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**20))
def test_decompose_dd_property_bitwise_jax(seed):
    x64 = _f64(seed, 6, 9) * np.exp(
        np.random.default_rng(seed + 1).uniform(-30, 30, (6, 9)))
    p = plimbs.decompose_dd(_pdd(x64), 7)
    j = jlimbs.decompose_dd(_jdd(x64), 7)
    np.testing.assert_array_equal(_limb_bits(p), np.asarray(j).view(np.int16))


# =========================================================================
# DD matmuls: the port against the JAX kernel (interpret mode) and golden
# =========================================================================
@pytest.mark.parametrize("shape", [(96, 128, 64), (37, 100, 29)],
                         ids=["test_kernels", "ragged"])
@pytest.mark.parametrize("mode", HIGH)
def test_dd_high_modes_match_jax_and_golden(mode, shape):
    """test_kernels.py's test_dd_high_modes on the port: the DD path beats
    f32 rounding of the inputs and agrees with JAX's kernel."""
    M, K, N = shape
    a64, b64 = _f64(3, M, K), _f64(4, K, N)
    kernels.reset_launch_counts()
    out = mp_matmul(_pdd(a64), _pdd(b64), mode)
    assert pkern.mp_both_prelimbed_matmul.plain_calls == 1
    gold = a64 @ b64
    rel = np.linalg.norm(out.numpy().astype(np.float64) - gold) \
        / np.linalg.norm(gold)
    assert rel < _golden_bound(K), rel
    j = jops.mp_matmul_pallas(_jdd(a64), _jdd(b64), mode, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=3e-6,
                               atol=1e-5)
    jr = jref.mp_matmul_ref(_jdd(a64), _jdd(b64), mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(jr), rtol=3e-6,
                               atol=1e-5)


@pytest.mark.parametrize("dd_side", ["a", "b"])
@pytest.mark.parametrize("mode", ["M23", "M52"])
def test_dd_times_f32_matches_jax(mode, dd_side):
    """A DD operand against an f32 one: the f32 side takes the decompose
    kernel's limbs (the plain cascade here), the DD side decompose_dd's."""
    a64, b64 = _f64(5, 40, 72), _f64(6, 72, 24)
    a32, b32 = a64.astype(np.float32), b64.astype(np.float32)
    if dd_side == "a":
        p = mp_matmul(_pdd(a64), torch.from_numpy(b32), mode)
        j = jops.mp_matmul_pallas(_jdd(a64), jnp.asarray(b32), mode,
                                  interpret=True)
    else:
        p = mp_matmul(torch.from_numpy(a32), _pdd(b64), mode)
        j = jops.mp_matmul_pallas(jnp.asarray(a32), _jdd(b64), mode,
                                  interpret=True)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=3e-6,
                               atol=1e-5)


@pytest.mark.parametrize("mode", BUILTINS)
def test_dd_ref_backend_matches_jax_ref(mode):
    """The port's ``ref`` backend on DD pairs against JAX's oracle: M8 takes
    the high words only, deeper formats decompose_dd's limbs."""
    a64, b64 = _f64(7, 24, 48), _f64(8, 48, 16)
    p = mp_matmul(_pdd(a64), _pdd(b64), mode, backend="ref")
    j = jref.mp_matmul_ref(_jdd(a64), _jdd(b64), mode)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=3e-6,
                               atol=1e-5)
    if mode == "M8":
        hi = mp_matmul(_pdd(a64).hi, _pdd(b64).hi, "M8", backend="ref")
        np.testing.assert_array_equal(p.numpy(), hi.numpy())


def test_golden_f64_takes_dd_pairs():
    a64, b64 = _f64(9, 8, 12), _f64(10, 12, 5)
    np.testing.assert_array_equal(
        pref.matmul_golden_f64(_pdd(a64), _pdd(b64)),
        jref.matmul_golden_f64(_jdd(a64), _jdd(b64)))


# =========================================================================
# the both-prelimbed plain version against the port's other kernels
# =========================================================================
@pytest.mark.parametrize("mode", BUILTINS + ("M30DD",))
def test_both_prelimbed_on_f32_stacks_is_bitwise_fused(mode, request):
    """On limb stacks cut from f32 operands, both-prelimbed == fused bit for
    bit: the same products, order sums and combine (the card holds this
    for the kernels; here for the plain versions)."""
    if mode == "M30DD":
        request.getfixturevalue("m30")
    fmt = resolve(mode)
    a = torch.from_numpy(_f64(11, 33, 70).astype(np.float32))
    b = torch.from_numpy(_f64(12, 70, 21).astype(np.float32))
    al = pkern.mp_decompose(a, fmt.n_limbs)
    bl = pkern.mp_decompose(b, fmt.n_limbs)
    both = pkern.mp_both_prelimbed_matmul(al, bl, fmt)
    fused = pkern.mp_fused_matmul(a, b, fmt)
    assert torch.equal(both.view(torch.int32), fused.view(torch.int32))


def test_missing_planes_read_as_zero_and_extra_planes_are_ignored():
    a64, b64 = _f64(13, 20, 30), _f64(14, 30, 10)
    al = plimbs.decompose_dd(_pdd(a64), 2)
    bl = plimbs.decompose_dd(_pdd(b64), 7)
    zeros = torch.zeros((1,) + tuple(al.shape[1:]), dtype=torch.bfloat16)
    short = pkern.mp_both_prelimbed_matmul(al, bl, "M23")
    padded = pkern.mp_both_prelimbed_matmul(torch.cat([al, zeros]), bl[:3],
                                            "M23")
    assert torch.equal(short, padded)


def test_ops_dd_path_is_one_launch_on_two_stacks():
    """``ops.mp_matmul_dd`` cuts an f32 operand with the decompose wrapper
    and runs one both-prelimbed call."""
    a64 = _f64(15, 16, 32)
    b32 = torch.from_numpy(_f64(16, 32, 8).astype(np.float32))
    kernels.reset_launch_counts()
    out = pops.mp_matmul_dd(_pdd(a64), b32, "M36")
    calls = kernels.plain_call_counts()
    assert calls["mp_decompose"] == 1
    assert calls["mp_both_prelimbed_matmul"] == 1
    assert sum(calls.values()) == 2
    al = plimbs.decompose_dd(_pdd(a64), 5)
    bl = plimbs.decompose(b32, 5)
    assert torch.equal(out, pkern.both_prelimbed_matmul_plain(al, bl, "M36"))


def test_dd_operands_are_2d_only():
    d = DD(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="2-D"):
        mp_matmul(d, torch.zeros(4, 5), "M36")


def test_dd_weights_run_per_branch_in_fused_proj():
    """DD weights in a projection group take per-branch ``mp_matmul`` calls
    with the shared epilogue, as pre-limbed weights do."""
    x = torch.from_numpy(_f64(17, 6, 24).astype(np.float32))
    w64 = [_f64(18 + i, 24, 10) for i in range(2)]
    out = mp_fused_proj(x, [_pdd(w) for w in w64], "M52", epilogue="swiglu")
    g, u = (mp_matmul(x, _pdd(w), "M52") for w in w64)
    assert torch.equal(out, pref.silu(g) * u)


# (M, K, N) across the both-prelimbed TMA tile's edges on the card: rows
# past 64 and 128 (the order split's and the row split's), columns past 48,
# 64 and 96, K off the 64-k chunk
BOTH_EDGES = [(65, 130, 49), (129, 65, 97), (17, 200, 65)]


@pytest.mark.parametrize("M,K,N", BOTH_EDGES)
@pytest.mark.parametrize("mode", HIGH)
def test_both_prelimbed_plain_matches_jax_kernel_at_tile_edges(mode, M, K, N):
    """The both-prelimbed plain version (what the card's TMA and mma.sync
    tiles are held to) on decompose_dd stacks against JAX's
    _both_prelimbed_kernel path (``ops.mp_matmul_pallas`` on DD operands,
    interpret mode) at test_dd_high_modes' tolerance (rtol 3e-6, atol
    1e-5: the same products, summed in blocks of another depth)."""
    a64, b64 = _f64(20, M, K), _f64(21, K, N)
    n = resolve(mode).n_limbs
    al = plimbs.decompose_dd(_pdd(a64), n)
    bl = plimbs.decompose_dd(_pdd(b64), n)
    out = pkern.both_prelimbed_matmul_plain(al, bl, mode)
    j = jops.mp_matmul_pallas(_jdd(a64), _jdd(b64), mode, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=3e-6,
                               atol=1e-5)
