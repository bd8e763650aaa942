"""PyTorch port: flash attention (port of the Pallas ``_flash_kernel``), the
chunk-scan fallback and dense-cache decode attention, held against the JAX
package on the same numpy inputs.

The flash wrapper's plain version blocks kv by the kernel's ``BLOCK_KV``;
JAX ``mp_attention_pallas(..., interpret=True)`` is run with the same
blocking, so only f32 summation order differs (tests/test_mp_attention.py's
same-blocking tolerance)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as jcontext
from repro.core import dispatch as jdispatch
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.kernels import mp_attention as jattn
from repro.kernels import ref as jref
from repro.models import attention as jmodels
from repro_torch.core import context as pcontext
from repro_torch.core import dispatch as pdispatch
from repro_torch.core.policy import PrecisionPolicy as PPolicy
from repro_torch.kernels import mp_attention as pattn
from repro_torch.kernels import ref as pref
from repro_torch.models import attention as pmodels
from torch_parity import assert_attention_close, assert_matmul_close


def _qkv(seed, B=2, S=32, T=None, H=2, Dh=16):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, Dh), (B, T, H, Dh), (B, T, H, Dh))]


CASES = {
    "causal-M16/M8": dict(S=64, T=64, causal=True, qk="M16", pv="M8"),
    "causal-ragged-M8/M8": dict(S=33, T=33, causal=True, qk="M8", pv="M8"),
    "bidir-ragged-M23/M16": dict(S=17, T=50, causal=False, qk="M23",
                                 pv="M16"),
    "bidir-M16/M23": dict(S=40, T=70, causal=False, qk="M16", pv="M23"),
    "q_offset-M23/M8": dict(S=8, T=40, causal=True, qk="M23", pv="M8",
                            q_offset=32),
    "q_offset-ragged-M16/M16": dict(S=11, T=75, causal=True, qk="M16",
                                    pv="M16", q_offset=64),
    "causal-M36/M52": dict(S=45, T=45, causal=True, qk="M36", pv="M52"),
}


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_flash_plain_matches_jax_kernel(case):
    q, k, v = _qkv(len(case) + case["S"], S=case["S"], T=case["T"])
    kw = dict(causal=case["causal"], q_offset=case.get("q_offset", 0))
    j = jattn.mp_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), case["qk"],
        case["pv"], interpret=True, block_q=pattn.BLOCK_Q,
        block_kv=pattn.BLOCK_KV, **kw)
    p = pattn.mp_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), case["qk"], case["pv"],
                                 **kw)
    assert_attention_close(p, j)


def test_q_tile_size_does_not_change_the_plain_version():
    """A kv tile processed for a q tile but above a row's diagonal is an
    exact no-op for that row, so the kernel's q tiling is invisible."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, S=70))
    a = pref.mp_attention_ref(q, k, v, "M16", "M8", block_q=32, block_kv=32)
    b = pref.mp_attention_ref(q, k, v, "M16", "M8", block_q=None,
                              block_kv=32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["M8", "M23"])
def test_ref_oracle_matches_jax_ref(mode):
    q, k, v = _qkv(21, S=24)
    j = jref.mp_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mode, "M16", causal=True)
    p = pdispatch.dispatch_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mode,
        "M16", causal=True, backend="ref")
    assert_attention_close(p, j)


@pytest.mark.parametrize("causal", [True, False])
def test_chunk_scan_matches_jax(causal):
    q, k, v = _qkv(31, S=33)
    pol_j = JPolicy({"attn_qk": "M16", "attn_pv": "M23"})
    pol_p = PPolicy({"attn_qk": "M16", "attn_pv": "M23"})
    j = jmodels.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), pol_j, causal=causal,
                                  q_chunk=16, kv_chunk=16)
    with pcontext.context(backend="ref"):
        p = pmodels.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), pol_p,
                                      causal=causal, q_chunk=16, kv_chunk=16)
    assert_attention_close(p, j)


def test_long_sequences_route_to_the_chunk_scan(monkeypatch):
    q, k, v = (torch.from_numpy(x) for x in _qkv(41, S=20))
    pol = PPolicy.serve_default()
    before = pattn.mp_flash_attention.plain_calls
    pmodels._self_attention(q, k, v, pol)
    assert pattn.mp_flash_attention.plain_calls == before + 1
    monkeypatch.setattr(pmodels, "FUSED_P_MAX_ELEMENTS", 2 * 2 * 20 * 20 - 1)
    out = pmodels._self_attention(q, k, v, pol, q_chunk=8, kv_chunk=8)
    assert pattn.mp_flash_attention.plain_calls == before + 1
    assert out.shape == q.shape


@pytest.mark.parametrize("length", [1, 13, 20])
def test_masked_decode_attention_matches_jax(length):
    rng = np.random.default_rng(length)
    q = rng.standard_normal((2, 1, 3, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 20, 3, 16)).astype(np.float32)
            for _ in range(2))
    j = jdispatch.masked_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(length),
        "M16", "M23", backend="pallas_interpret")
    p = pdispatch.masked_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        length, "M16", "M23", backend="cuda")
    assert_matmul_close(p, np.asarray(j))


def test_gqa_forward_no_cache_matches_jax():
    """The attention block (fused QKV, RoPE, flash, wo) on GQA widths."""
    rng = np.random.default_rng(5)
    dims_j = jmodels.AttnDims(d_model=32, n_heads=4, n_kv_heads=2,
                              head_dim=8)
    dims_p = pmodels.AttnDims(d_model=32, n_heads=4, n_kv_heads=2,
                              head_dim=8)
    params = {"wq": rng.standard_normal((32, 32)), "wk":
              rng.standard_normal((32, 16)), "wv": rng.standard_normal(
                  (32, 16)), "wo": rng.standard_normal((32, 32))}
    params = {n: (w * 0.2).astype(np.float32) for n, w in params.items()}
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    pol_j, pol_p = JPolicy.full_fp32(), PPolicy.full_fp32()
    with jcontext.context(backend="pallas_interpret"):
        j, _ = jmodels.gqa_forward({n: jnp.asarray(w) for n, w in
                                    params.items()}, jnp.asarray(x), dims_j,
                                   pol_j)
    p, _ = pmodels.gqa_forward({n: torch.from_numpy(w) for n, w in
                                params.items()}, torch.from_numpy(x), dims_p,
                               pol_p)
    assert_attention_close(p, j)
