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
from repro_torch.core.formats import resolve
from repro_torch.core.policy import PrecisionPolicy as PPolicy
from repro_torch.kernels import mp_attention as pattn
from repro_torch.kernels import ref as pref
from repro_torch.models import attention as pmodels
from torch_parity import assert_attention_close, assert_matmul_close


def _qkv(seed, B=2, S=32, T=None, H=2, Dh=16, plant=()):
    """q, k, v from ``seed``; for each (row, position, gain) of ``plant``, K
    at the position becomes the multiple of each head's query row that
    gives that row the logit ``gain`` (scale Dh^-1/2)."""
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    q, k, v = [rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, Dh), (B, T, H, Dh), (B, T, H, Dh))]
    for s, t, gain in plant:
        qr = q[:, s]
        k[:, t] = gain * qr / ((qr * qr).sum(-1, keepdims=True) * Dh ** -0.5)
    return q, k, v


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
    # the scheduler's B = 1 paged prefill: S on and one past the tiles
    "B1-prefill-64-M16/M8": dict(B=1, S=64, T=64, causal=True, qk="M16",
                                 pv="M8"),
    "B1-prefill-65-M16/M8": dict(B=1, S=65, T=65, causal=True, qk="M16",
                                 pv="M8"),
    # a row's largest logit in the last column of a kv tile (31 and 63)
    "max-in-tile-last-column-M16/M8": dict(
        S=70, T=70, causal=True, qk="M16", pv="M8",
        plant=((40, 31, 6.0), (66, 63, 6.0), (63, 63, 6.0))),
}


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_flash_plain_matches_jax_kernel(case):
    q, k, v = _qkv(len(case) + case["S"], B=case.get("B", 2), S=case["S"],
                   T=case["T"], plant=case.get("plant", ()))
    kw = dict(causal=case["causal"], q_offset=case.get("q_offset", 0))
    j = jattn.mp_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), case["qk"],
        case["pv"], interpret=True, block_q=pattn.BLOCK_Q,
        block_kv=pattn.BLOCK_KV, **kw)
    p = pattn.mp_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), case["qk"], case["pv"],
                                 **kw)
    assert_attention_close(p, j)


@pytest.mark.parametrize("block_q", [16, 32, 64, 128])
def test_q_tile_size_does_not_change_the_plain_version(block_q):
    """A kv tile processed for a q tile but above a row's diagonal is an
    exact no-op for that row, so the kernel's q tiling is invisible: every
    q tile the kernel's blocks (16, 32, 64 rows) or the order (32) take
    gives the bits of one q tile of all rows."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, S=150))
    kw = dict(block_kv=pattn.BLOCK_KV, qk_dot=pref.dot_nt_in_order)
    a = pref.mp_attention_ref(q, k, v, "M16", "M8", block_q=block_q, **kw)
    b = pref.mp_attention_ref(q, k, v, "M16", "M8", block_q=None, **kw)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("shape", [((2, 3, 5, 16), (2, 3, 7, 16)),
                                   ((1, 2, 4, 64), (2, 1, 33, 64))])
def test_dot_nt_in_order_is_a_sequential_f32_sum(shape):
    """The QK dot of the flash and paged plain versions is the kernels'
    chain: per logit one f32 sum of the exact bf16 products in dim order
    from +0.0, bitwise numpy's float32 loop term by term (batch dims
    broadcast, as the flash plain version's (B, H) do)."""
    rng = np.random.default_rng(len(shape[0]) + shape[0][-1])
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16().float() for s in shape)
    got = pref.dot_nt_in_order(a, b).numpy()
    an, bn = a.numpy(), b.numpy()
    want = np.zeros(np.broadcast_shapes(an.shape[:-2], bn.shape[:-2])
                    + (an.shape[-2], bn.shape[-2]), np.float32)
    for e in range(an.shape[-1]):
        want = want + an[..., :, None, e] * bn[..., None, :, e]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_flash_plain_sums_qk_in_the_kernels_order():
    """The flash wrapper's plain version is the blocked oracle with the
    in-order QK dot, not torch.matmul's order."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, S=40))
    got = pattn.flash_attention_plain(q, k, v, resolve("M16"), resolve("M8"))
    want = pref.mp_attention_ref(q, k, v, "M16", "M8",
                                 block_q=pattn.BLOCK_Q,
                                 block_kv=pattn.BLOCK_KV,
                                 qk_dot=pref.dot_nt_in_order)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
