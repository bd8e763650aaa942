"""Shared tolerances for the PyTorch port's parity tests (tests/test_torch_*).

Both packages get the same numpy inputs; the port's output is held against
the JAX package's at the tolerance of the JAX suite's own kernel-vs-oracle
checks: the two realize the same limb products and differ only in the order
of their f32 sums."""
import numpy as np
import torch


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_matmul_close(out, ref, gold=None):
    """tests/test_kernels.py's kernel-vs-oracle tolerance: rtol 2e-6 and an
    atol of 2e-6 scaled by the output's norm (per element)."""
    out, ref = np32(out), np32(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = np.linalg.norm(np.asarray(ref if gold is None else gold,
                                      np.float64))
    np.testing.assert_allclose(out, ref, rtol=2e-6,
                               atol=2e-6 * scale / np.sqrt(max(ref.size, 1)))


def assert_attention_close(out, ref):
    """tests/test_mp_attention.py's same-blocking tolerance."""
    out, ref = np32(out), np32(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
