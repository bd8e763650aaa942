"""PyTorch port: the fused limb matmul (port of the Pallas ``_fused_kernel``)
and the ``ref`` backend, held against the JAX package on the same numpy
inputs.

The port's wrapper runs its plain version on CPU tensors; it is compared
with JAX ``ops.mp_matmul_pallas(..., interpret=True)`` at every built-in
format, 2-D, batched and both-batched, on ragged shapes, at
tests/test_kernels.py's tolerances.  The port's ``ref`` backend is compared
with JAX ``ref.mp_matmul_ref`` (both accumulation disciplines)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import dispatch as pdispatch
from repro_torch.core.mpmatmul import mp_einsum_qk, mp_matmul
from repro_torch.kernels import mp_matmul as pkern
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from torch_parity import assert_matmul_close

MODES = ("M8", "M16", "M23", "M36", "M52")
SHAPES = {"aligned": (128, 128, 128), "ragged": (100, 200, 72),
          "skinny": (8, 1024, 16)}


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _err_bound(mode, K):
    """tests/test_kernels.py's calibrated error model vs the f64 golden."""
    from repro_torch.core.formats import resolve
    s = resolve(mode)
    return max(2.0 ** (-(8 * min(s.n_limbs, 3) - 2)), 8 * 2.0 ** -24 * np.sqrt(K))


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("mode", MODES)
def test_fused_matmul_plain_matches_jax_kernel(mode, shape):
    M, K, N = shape
    a, b = _inputs(42, (M, K), (K, N))
    j = jops.mp_matmul_pallas(jnp.asarray(a), jnp.asarray(b), mode,
                              interpret=True)
    p = pkern.mp_fused_matmul(torch.from_numpy(a), torch.from_numpy(b), mode)
    gold = pref.matmul_golden_f64(a, b)
    assert_matmul_close(p, j, gold)
    rel = np.linalg.norm(p.numpy().astype(np.float64) - gold) \
        / np.linalg.norm(gold)
    assert rel < _err_bound(mode, K)


@pytest.mark.parametrize("mode", ["M16", "M36"])
def test_both_batched_one_call_matches_jax(mode):
    """The decode-attention form: both operands batched (with a broadcast
    dim) — one kernel call in the port, a vmap in JAX."""
    a, b = _inputs(3, (3, 4, 5, 64), (1, 4, 64, 37))
    j = jops.mp_matmul_pallas(jnp.asarray(a), jnp.asarray(b), mode,
                              interpret=True)
    p = pops.mp_matmul_cuda(torch.from_numpy(a), torch.from_numpy(b), mode)
    assert_matmul_close(p, j)


def test_decode_qk_on_transposed_cache_view_matches_jax():
    """q (B, H, 1, Dh) against the cache read as a transposed view, the
    operand ``mp_einsum_qk`` passes (non-contiguous, no copy)."""
    q, k = _inputs(5, (2, 3, 1, 16), (2, 40, 3, 16))
    kh = torch.from_numpy(k).permute(0, 2, 1, 3)            # (B, H, T, Dh)
    p = mp_einsum_qk(torch.from_numpy(q), kh, "M16", backend="cuda")
    j = jops.mp_matmul_pallas(jnp.asarray(q),
                              jnp.swapaxes(jnp.asarray(k).transpose(
                                  0, 2, 1, 3), -1, -2), "M16", interpret=True)
    assert not kh.transpose(-1, -2).is_contiguous()
    assert_matmul_close(p, j)


def test_batched_activation_folds_into_rows():
    a, b = _inputs(9, (2, 5, 7, 48), (48, 40))
    j = jops.mp_matmul_pallas(jnp.asarray(a), jnp.asarray(b), "M23",
                              interpret=True)
    p = mp_matmul(torch.from_numpy(a), torch.from_numpy(b), "M23",
                  backend="cuda")
    assert p.shape == (2, 5, 7, 40)
    assert_matmul_close(p, j)


@pytest.mark.parametrize("mode", MODES)
def test_ref_backend_matches_jax_ref(mode):
    """Plain adds at <= 3 limbs, per-order sums + Neumaier above."""
    a, b = _inputs(17, (2, 33, 70), (70, 29))
    j = jref.mp_matmul_ref(jnp.asarray(a), jnp.asarray(b), mode)
    p = pdispatch.dispatch(torch.from_numpy(a), torch.from_numpy(b), mode,
                           backend="ref")
    assert_matmul_close(p, j)


def test_wrapper_launches_only_for_cuda_tensors():
    """CPU tensors run the plain version and never count a launch."""
    a, b = (torch.from_numpy(x) for x in _inputs(1, (4, 8), (8, 4)))
    before_l, before_p = (pkern.mp_fused_matmul.launches,
                          pkern.mp_fused_matmul.plain_calls)
    out = pkern.mp_fused_matmul(a, b, "M16")
    assert pkern.mp_fused_matmul.launches == before_l
    assert pkern.mp_fused_matmul.plain_calls == before_p + 1
    torch.testing.assert_close(out, pkern.fused_matmul_plain(a, b, "M16"),
                               rtol=0, atol=0)


def test_auto_mode_is_not_ported_yet():
    a = torch.ones(2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mp_matmul(a, a, "AUTO")
