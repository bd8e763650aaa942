"""PyTorch port: pre-limbed decode weights (port of the Pallas
``_decompose_kernel`` and ``_prelimbed_kernel``), held against the JAX
package on the same numpy inputs.

Tolerances: decomposition is the same round-to-nearest-even cascade on both
sides, so it is held bitwise.  The pre-limbed matmul sums the same exact limb
products as JAX's interpret-mode kernel in another f32 order
(tests/test_kernels.py's kernel-vs-oracle tolerance, ``torch_parity``); inside
the port it repeats ``fused_matmul_plain``'s sums on the same limbs, so the
two are held bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import limbs as jlimbs
from repro.core import mpmatmul as jmp
from repro.core.limbs import PrelimbedWeight as JPrelimbed
from repro.kernels import ops as jops
from repro_torch.core import limbs as plimbs
from repro_torch.core import mpmatmul as pmp
from repro_torch.core.formats import resolve
from repro_torch.core.limbs import PrelimbedWeight as PPrelimbed
from repro_torch.kernels import mp_matmul as pmm
from repro_torch.kernels import ops as pops
from torch_parity import assert_matmul_close


def _bits(x) -> np.ndarray:
    """The bit pattern of a bf16 array (JAX or torch) as uint16 (via the
    exact widening to f32)."""
    if isinstance(x, torch.Tensor):
        f = x.float().numpy()
    else:
        f = np.asarray(x).astype(np.float32)
    return (f.view(np.uint32) >> 16).astype(np.uint16)


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
@pytest.mark.parametrize("shape", [(37, 300), (64, 128)])
def test_decompose_matches_jax_bitwise(n_limbs, shape):
    w = _rand(n_limbs + shape[0], *shape)
    w[0, :4] = [0.0, -0.0, 1e-30, -3.3e38]  # signed zeros, tiny, near max
    before = pmm.mp_decompose.plain_calls
    p = pops.decompose_weights(torch.from_numpy(w), n_limbs)
    assert pmm.mp_decompose.plain_calls == before + 1
    assert p.dtype == torch.bfloat16 and p.shape == (n_limbs,) + shape
    j = jops.decompose_weights(jnp.asarray(w), n_limbs, interpret=True)
    np.testing.assert_array_equal(_bits(p), _bits(j))
    # the oracle: the (..., L, K, N) PrelimbedWeight layout of both packages
    jw = jlimbs.prelimb_weight(jnp.asarray(w), n_limbs)
    pw = plimbs.prelimb_weight(torch.from_numpy(w), n_limbs)
    assert pw.shape == tuple(jw.shape) and pw.n_limbs == jw.n_limbs
    assert pw.ndim == jw.ndim == 2
    np.testing.assert_array_equal(_bits(pw.limbs), _bits(jw.limbs))


def test_decompose_is_depth_stable():
    """The first k limbs of a deeper stack are the k-limb stack."""
    w = torch.from_numpy(_rand(3, 20, 33))
    deep = pmm.mp_decompose(w, 5)
    for k in (1, 2, 3):
        assert torch.equal(pmm.mp_decompose(w, k), deep[:k])


# (mode, stored limbs): fewer than the format needs (missing limbs count as
# zero) and more (extra limbs are ignored)
PRELIMBED_CASES = [("M8", 1), ("M8", 3), ("M16", 1), ("M16", 3), ("M23", 2),
                   ("M23", 4), ("M36", 3), ("M36", 6)]


@pytest.mark.parametrize("mode,n_stored", PRELIMBED_CASES)
def test_prelimbed_matmul_matches_jax_kernel(mode, n_stored):
    x = _rand(11, 24, 96)
    w = _rand(12, 96, 80, scale=0.1)
    j_limbs = jops.decompose_weights(jnp.asarray(w), n_stored,
                                     interpret=True)
    j = jops.mp_matmul_prelimbed_weights(jnp.asarray(x), j_limbs, mode,
                                         interpret=True)
    before = pmm.mp_prelimbed_matmul.plain_calls
    p = pops.mp_matmul_prelimbed_weights(
        torch.from_numpy(x), pmm.mp_decompose(torch.from_numpy(w), n_stored),
        mode)
    assert pmm.mp_prelimbed_matmul.plain_calls == before + 1
    assert_matmul_close(p, np.asarray(j))


@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M36", "M52"])
def test_prelimbed_plain_equals_fused_plain_bitwise(mode):
    """On limbs decomposed from a raw weight, the pre-limbed plain version
    gives the fused plain version's result on that weight bit for bit (so
    pre-limbing cannot move a token)."""
    x = torch.from_numpy(_rand(21, 9, 70))
    w = torch.from_numpy(_rand(22, 70, 45, scale=0.3))
    n = resolve(mode).n_limbs
    fused = pmm.fused_matmul_plain(x, w, mode)
    for stored in (n, n + 1):
        out = pmm.mp_prelimbed_matmul(x, pmm.mp_decompose(w, stored), mode)
        assert torch.equal(out, fused), (mode, stored)


def test_prelimbed_weight_routes_through_mp_matmul_and_ref():
    """``mp_matmul`` on a PrelimbedWeight: the pre-limbed kernel wrapper on
    the ``cuda`` route, the oracle on ``ref``; both equal the raw weight's
    result at the same format."""
    x = torch.from_numpy(_rand(31, 2, 5, 40))
    w = torch.from_numpy(_rand(32, 40, 24, scale=0.2))
    pw = plimbs.prelimb_weight(w, 2)
    before = pmm.mp_prelimbed_matmul.plain_calls
    out = pmp.mp_dense(x, pw, "M16")
    assert pmm.mp_prelimbed_matmul.plain_calls == before + 1
    assert out.shape == (2, 5, 24)
    assert torch.equal(out, pmp.mp_dense(x, w, "M16"))
    ref = pmp.mp_dense(x, pw, "M16", backend="ref")
    assert torch.equal(ref, pmp.mp_dense(x, w, "M16", backend="ref"))
    with pytest.raises(ValueError, match="2-D"):
        pmp.mp_matmul(x, PPrelimbed(pw.limbs[None]), "M16")


@pytest.mark.parametrize("mode", ["M8", "M16", "M23"])
@pytest.mark.parametrize("kind", ["qkv", "swiglu", "swiglu+bias+res",
                                  "one+res"])
def test_fused_proj_on_prelimbed_weights_matches_jax_ref(mode, kind):
    """``mp_fused_proj`` / ``mp_swiglu`` with pre-limbed weights run per
    branch with the shared epilogue, against JAX's ``mp_fused_proj`` on the
    ``ref`` backend with JAX-pre-limbed weights."""
    n = resolve(mode).n_limbs
    x = _rand(41, 6, 48)
    n_out = {"qkv": 3, "swiglu": 2, "swiglu+bias+res": 2, "one+res": 1}[kind]
    ws = [_rand(42 + t, 48, 32, scale=0.2) for t in range(n_out)]
    biases = ([_rand(50 + t, 32) for t in range(n_out)]
              if "bias" in kind else None)
    res = _rand(60, 6, 32) if "res" in kind else None
    gate = "swiglu" if "swiglu" in kind else "none"
    jws = [jlimbs.prelimb_weight(jnp.asarray(w), n) for w in ws]
    pws = [pmm_prelimb(w, n) for w in ws]
    assert all(isinstance(w, JPrelimbed) for w in jws)
    j = jmp.mp_fused_proj(
        jnp.asarray(x), jws, mode, epilogue=gate,
        biases=None if biases is None else [jnp.asarray(b) for b in biases],
        residual=None if res is None else jnp.asarray(res), backend="ref")
    p = pmp.mp_fused_proj(
        torch.from_numpy(x), pws, mode, epilogue=gate,
        biases=None if biases is None else [torch.from_numpy(b)
                                            for b in biases],
        residual=None if res is None else torch.from_numpy(res))
    js = j if isinstance(j, tuple) else (j,)
    ps = p if isinstance(p, tuple) else (p,)
    assert len(js) == len(ps)
    for a, b in zip(ps, js):
        assert_matmul_close(a, np.asarray(b))
    if gate == "swiglu":
        sw = pmp.mp_swiglu(torch.from_numpy(x), pws[0], pws[1], mode,
                           biases=None if biases is None else
                           [torch.from_numpy(b) for b in biases],
                           residual=None if res is None else
                           torch.from_numpy(res))
        assert torch.equal(sw, p)


def pmm_prelimb(w: np.ndarray, n: int) -> PPrelimbed:
    """A weight pre-limbed the way the serving engine does it (the
    decompose kernel wrapper, one call per matrix)."""
    return PPrelimbed(pmm.mp_decompose(torch.from_numpy(w), n))
