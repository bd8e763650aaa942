"""PyTorch port: paged decode attention (port of the Pallas
``_paged_kernel``) and the paged pool write, held against the JAX package on
the same numpy inputs.

The plain version steps through the same pool blocks as JAX's interpret-mode
kernel, one online-softmax update per block of ``bs`` positions, so only
f32 summation order differs: tests/test_mp_attention.py's same-blocking
tolerance (2e-5 + 2e-5 * |ref|, ``torch_parity``).  The pool write moves
values without arithmetic and is held bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.kernels import mp_attention as jattn
from repro.models import attention as jmodels
from repro.serve.kv_cache import PagedKVCache as JPagedKVCache
from repro_torch.core import dispatch as pdispatch
from repro_torch.kernels import mp_attention as pattn
from repro_torch.models import attention as pmodels
from repro_torch.serve.kv_cache import TRASH_BLOCK
from repro_torch.serve.kv_cache import PagedKVCache as PPagedKVCache
from torch_parity import assert_attention_close

N_BLOCKS, BS, W, DH = 16, 4, 4, 16


def _paged_inputs(seed, lengths, H=4, Hkv=4):
    """q (B, H, Dh), pools (n_blocks, bs, Hkv, Dh), a trash-padded table of
    distinct live blocks (ceil(length / bs) per slot) and int32 lengths."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = rng.standard_normal((B, H, DH)).astype(np.float32)
    kp = rng.standard_normal((N_BLOCKS, BS, Hkv, DH)).astype(np.float32)
    vp = rng.standard_normal((N_BLOCKS, BS, Hkv, DH)).astype(np.float32)
    free = list(rng.permutation(np.arange(1, N_BLOCKS)))
    table = np.full((B, W), TRASH_BLOCK, np.int32)
    for b, n in enumerate(lengths):
        for j in range(-(-n // BS)):
            table[b, j] = free.pop()
    return q, kp, vp, table, np.asarray(lengths, np.int32)


CASES = {
    f"{qk}/{pv}-Hkv{hkv}-len{'_'.join(map(str, ln))}": (qk, pv, hkv, ln)
    for qk, pv in (("M16", "M8"), ("M23", "M16"))
    for hkv in (4, 2)
    for ln in ((0, 3, 13), (4, 13, 3))
}


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_paged_plain_matches_jax_kernel(case):
    qk, pv, hkv, lengths = case
    q, kp, vp, table, ln = _paged_inputs(sum(lengths) + hkv, lengths,
                                         Hkv=hkv)
    j = jattn.mp_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(ln), qk, pv, interpret=True)
    before = pattn.mp_paged_attention.plain_calls
    p = pattn.mp_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(ln), qk, pv)
    assert pattn.mp_paged_attention.plain_calls == before + 1
    assert_attention_close(p, np.asarray(j))
    for b, n in enumerate(lengths):
        if n == 0:  # an empty slot flushes exact zeros on both sides
            assert not p[b].any() and not np.asarray(j)[b].any()


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_dispatch_paged_attention_matches_jax_route(hkv, backend):
    """The port's two routes against the JAX package's same route, q
    (B, 1, H, Dh): ``ref`` gathers the table and runs the masked einsums on
    both sides; ``cuda`` runs the paged kernel's plain version, held
    against JAX's ``pallas_interpret`` route (the paged kernel).  (The two
    routes limb P differently, per pool block against a running max or
    once against the row max, so they agree only to M8's budget.)"""
    q, kp, vp, table, ln = _paged_inputs(7 + hkv, (5, 0, 16), Hkv=hkv)
    q4 = q[:, None]
    j = jdispatch.dispatch_paged_attention(
        jnp.asarray(q4), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(ln), "M16", "M8",
        backend={"ref": "ref", "cuda": "pallas_interpret"}[backend])
    p = pdispatch.dispatch_paged_attention(
        torch.from_numpy(q4), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(ln), "M16", "M8",
        backend=backend)
    assert p.shape == q4.shape
    assert_attention_close(p, np.asarray(j))
    assert not p[1].any()


def test_masked_decode_attention_takes_per_slot_lengths():
    """(B,) lengths mask each slot at its own length: row b equals the
    scalar-length call at lengths[b]."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((3, 1, 2, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((3, 10, 2, 8))
                             .astype(np.float32)) for _ in range(2))
    lengths = torch.tensor([2, 10, 7], dtype=torch.int32)
    out = pdispatch.masked_decode_attention(q, k, v, lengths, "M16", "M8",
                                            backend="ref")
    for b, n in enumerate(lengths.tolist()):
        one = pdispatch.masked_decode_attention(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], n, "M16", "M8",
            backend="ref")
        assert torch.equal(out[b:b + 1], one)


def test_paged_write_matches_jax_bitwise():
    """A prefill-shaped write (S = 8 positions from each slot's length),
    including positions past the table's width: those go to the trash block,
    never into the row's last real block."""
    rng = np.random.default_rng(11)
    hk, S = 2, 8
    pool_k = rng.standard_normal((N_BLOCKS, BS, hk, DH)).astype(np.float32)
    pool_v = rng.standard_normal((N_BLOCKS, BS, hk, DH)).astype(np.float32)
    table = np.asarray([[3, 7, 0, 0], [5, 9, 11, 2]], np.int32)
    lengths = np.asarray([0, 12], np.int32)   # slot 1 writes 12..19: past W*bs
    k = rng.standard_normal((2, S, hk, DH)).astype(np.float32)
    v = rng.standard_normal((2, S, hk, DH)).astype(np.float32)
    positions = lengths[:, None] + np.arange(S)[None, :]
    j = jmodels._paged_write(
        JPagedKVCache(jnp.asarray(pool_k), jnp.asarray(pool_v),
                      jnp.asarray(table), jnp.asarray(lengths)),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions))
    pk, pv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    p = pmodels._paged_write(
        PPagedKVCache(pk, pv, torch.from_numpy(table),
                      torch.from_numpy(lengths)),
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(positions))
    assert p.k is pk and p.v is pv  # written in place
    assert p.length.tolist() == (lengths + S).tolist()
    live = [b for b in range(N_BLOCKS) if b != TRASH_BLOCK]
    for got, want in ((pk, j.k), (pv, j.v)):
        np.testing.assert_array_equal(got.numpy()[live],
                                      np.asarray(want)[live])
    # slot 1: positions 12..15 fill its last real block (2), 16..19 go to
    # trash; slot 0's padded tail 4..7 lands in its own block 7
    np.testing.assert_array_equal(pk.numpy()[2], k[1, :4])
    np.testing.assert_array_equal(pk.numpy()[7], k[0, 4:])
    untouched = [b for b in live if b not in (3, 7, 2)]
    np.testing.assert_array_equal(pk.numpy()[untouched], pool_k[untouched])
