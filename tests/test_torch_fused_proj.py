"""PyTorch port: the fused multi-output projection (port of the Pallas
``_fused_multi_kernel``) held against JAX
``ops.mp_fused_proj_pallas(..., interpret=True)`` on the same numpy inputs:
n_out 1/2/3, the swiglu gate, biases, the residual, and unequal (GQA)
widths, which the wrapper concatenates along N."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.mpmatmul import mp_fused_proj, mp_qkv_proj, mp_swiglu
from repro_torch.kernels import mp_matmul as pkern
from repro_torch.kernels import ops as pops
from torch_parity import assert_matmul_close


def _inputs(seed, M=37, K=48, Ns=(24,), bias=False, residual=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    ws = [rng.standard_normal((K, n)).astype(np.float32) for n in Ns]
    bs = [rng.standard_normal(n).astype(np.float32) for n in Ns] \
        if bias else None
    res = rng.standard_normal((M, Ns[0])).astype(np.float32) \
        if residual else None
    return x, ws, bs, res


def _both(x, ws, mode, bs=None, res=None, gate="none"):
    j = jops.mp_fused_proj_pallas(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], mode, gate=gate,
        biases=None if bs is None else [jnp.asarray(b) for b in bs],
        residual=None if res is None else jnp.asarray(res), interpret=True)
    p = pops.mp_fused_proj_cuda(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws], mode,
        gate=gate, biases=None if bs is None else [torch.from_numpy(b)
                                                    for b in bs],
        residual=None if res is None else torch.from_numpy(res))
    return j, p


def _assert_outputs(j, p):
    j = j if isinstance(j, tuple) else (j,)
    p = p if isinstance(p, tuple) else (p,)
    assert len(j) == len(p)
    for a, b in zip(p, j):
        assert_matmul_close(a, b)


@pytest.mark.parametrize("n_out", [1, 2, 3])
@pytest.mark.parametrize("mode", ["M8", "M16", "M23"])
def test_equal_width_outputs_match_jax(mode, n_out):
    x, ws, _, _ = _inputs(n_out, Ns=(24,) * n_out)
    _assert_outputs(*_both(x, ws, mode))


@pytest.mark.parametrize("mode", ["M8", "M16", "M36"])
def test_swiglu_bias_residual_match_jax(mode):
    x, ws, bs, res = _inputs(7, Ns=(40, 40), bias=True, residual=True)
    _assert_outputs(*_both(x, ws, mode, bs, res, gate="swiglu"))


def test_swiglu_plain_gate_matches_jax():
    x, ws, _, _ = _inputs(8, M=5, K=64, Ns=(128, 128))
    _assert_outputs(*_both(x, ws, "M8", gate="swiglu"))


def test_bias_on_three_outputs_and_residual_on_one():
    x, ws, bs, _ = _inputs(9, Ns=(24, 24, 24), bias=True)
    _assert_outputs(*_both(x, ws, "M16", bs))
    x, ws, bs, res = _inputs(10, Ns=(24,), bias=True, residual=True)
    _assert_outputs(*_both(x, ws, "M52", bs, res))


@pytest.mark.parametrize("mode", ["M8", "M23"])
def test_unequal_gqa_widths_concatenate_along_n(mode):
    """wq wider than wk/wv: one wide contraction, outputs sliced back."""
    x, ws, bs, _ = _inputs(11, Ns=(64, 32, 32), bias=True)
    j, p = _both(x, ws, mode, bs)
    assert [t.shape[-1] for t in p] == [64, 32, 32]
    _assert_outputs(j, p)


def test_leading_dims_and_public_ops():
    """(B, S, K) activations through mp_qkv_proj / mp_swiglu match the JAX
    ref oracle's fused projection."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ws = [rng.standard_normal((32, 16)).astype(np.float32) for _ in range(3)]
    xt, wt = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    q, k, v = mp_qkv_proj(xt, *wt, "M16", backend="cuda")
    jq = jref.mp_fused_proj_ref(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                "M16")
    _assert_outputs(jq, (q, k, v))
    h = mp_swiglu(xt, wt[0], wt[1], "M16", backend="ref")
    jh = jref.mp_fused_proj_ref(jnp.asarray(x), [jnp.asarray(w)
                                                 for w in ws[:2]], "M16",
                                gate="swiglu")
    _assert_outputs(jh, h)


def test_more_than_three_equal_weights_split_into_launch_groups():
    x, ws, _, _ = _inputs(13, Ns=(16,) * 5)
    before = pkern.mp_fused_proj.plain_calls
    j, p = _both(x, ws, "M8")
    assert pkern.mp_fused_proj.plain_calls == before + 2
    _assert_outputs(j, p)


def test_validation_errors():
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 4)
    with pytest.raises(ValueError):
        mp_fused_proj(x, (w, w, w), "M8", epilogue="swiglu")
    with pytest.raises(ValueError):
        mp_fused_proj(x, (w, w), "M8", residual=torch.zeros(4, 4))
    with pytest.raises(ValueError):
        mp_fused_proj(x, (w, torch.zeros(8, 2)), "M8", epilogue="swiglu")
    with pytest.raises(ValueError):
        mp_fused_proj(x, (w,), "M8", epilogue="gelu")
