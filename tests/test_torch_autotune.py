"""The port's autotuner (``repro_torch.kernels.autotune``) and its switch
against the JAX package's (``repro.kernels.autotune``,
``repro.core.context.autotune_enabled``): the table keys are JAX's strings,
the switch and the context JSON behave as ``tests/test_mp_api.py`` holds
JAX's, the shared-memory mirrors give the kernels' numbers (the ones the
libraries export; ``tests/test_torch_gpu.py`` holds the two equal on the
card), and dispatch reads the table on the card's route only.  Nothing here
needs a card: sweeps run there (``chip_smoke.py`` ``[autotune]``)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.mp as mp
from repro.kernels import autotune as jat
from repro_torch.core import context as context_lib
from repro_torch.core import dispatch
from repro_torch.core.formats import register_format, unregister_format
from repro_torch.kernels import autotune as at
from repro_torch.kernels import build, mp_attention, ops


@pytest.fixture
def table_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_MP_AUTOTUNE", raising=False)
    at.clear_memory_cache()
    at.reset_stats()
    context_lib.reset_context()
    yield tmp_path
    at.clear_memory_cache()
    context_lib.reset_context()


@pytest.mark.parametrize("M,K,N,mode,n_out,epilogue", [
    (2048, 768, 768, "M16", 1, "none"),
    (8, 768, 3072, "M8", 2, "swiglu"),
    (2048, 768, 768, "M23", 3, "none"),
    (70, 96, 128, "M52", 1, "bias+res"),
    (1, 64, 64, "M36", 2, "swiglu+bias"),
])
def test_table_key_is_jax(M, K, N, mode, n_out, epilogue):
    got = at.table_key(M, K, N, mode, torch.float32, n_out=n_out,
                       epilogue=epilogue)
    assert got == jat.table_key(M, K, N, mode, jnp.float32, n_out=n_out,
                                epilogue=epilogue)
    assert at.table_key(M, K, N, mode, np.float32, n_out=n_out,
                        epilogue=epilogue) == got


def test_keys_of_a_registered_format_are_jax():
    register_format("X21AT", mantissa_bits=21, n_limbs=3, max_order=1)
    from repro.core.formats import register_format as jreg, \
        unregister_format as junreg
    jreg("X21AT", mantissa_bits=21, n_limbs=3, max_order=1)
    try:
        assert at.table_key(16, 32, 64, "X21AT", torch.float32) == \
            jat.table_key(16, 32, 64, "X21AT", jnp.float32)
        assert at.attention_table_key(96, 256, 256, 64, "X21AT", "M8",
                                      causal=True) == \
            jat.attention_table_key(96, 256, 256, 64, "X21AT", "M8",
                                    causal=True)
    finally:
        unregister_format("X21AT")
        junreg("X21AT")


@pytest.mark.parametrize("causal,paged", [(True, False), (False, False),
                                          (True, True), (False, True)])
def test_attention_key_is_jax(causal, paged):
    args = (96, 256, 512, 64, "M16", "M8")
    assert at.attention_table_key(*args, causal=causal, paged=paged) == \
        jat.attention_table_key(*args, causal=causal, paged=paged)


def test_epilogue_desc_is_jax():
    from repro.kernels import mp_matmul as jkern

    for gate in ("none", "swiglu"):
        for bias in (False, True):
            for res in (False, True):
                assert at.epilogue_desc(gate, bias, res) == \
                    jkern.epilogue_desc(gate, bias, res)


def test_env_switch_is_live(table_dir, monkeypatch):
    """``tests/test_mp_api.py::test_env_autotune_shim_is_live``: the env
    var is read on every call; an explicitly configured flag wins."""
    assert not context_lib.autotune_enabled()
    monkeypatch.setenv("REPRO_MP_AUTOTUNE", "1")
    assert context_lib.autotune_enabled()   # flipped after the first read
    with mp.context(autotune=False):
        assert not context_lib.autotune_enabled()
    mp.configure(autotune=False)
    assert not context_lib.autotune_enabled()
    monkeypatch.delenv("REPRO_MP_AUTOTUNE")
    mp.configure(autotune=True)
    assert context_lib.autotune_enabled()


def test_configure_and_context_take_autotune(table_dir):
    """``tests/test_mp_api.py::test_configure_replaces_global_and_env_shims``
    on the port's backends."""
    mp.configure(backend="ref", auto_tol=2.0 ** -6)
    with mp.context(autotune=True):
        assert mp.current_context().backend == "ref"
        assert mp.current_context().autotune
    assert mp.current_context().autotune is None
    with pytest.raises(ValueError):
        mp.configure(backend="nope")


@pytest.mark.parametrize("flag", [None, False, True])
def test_context_json_round_trips_autotune(flag):
    from repro.core.context import PrecisionContext as JCtx

    ctx = mp.PrecisionContext(backend="ref", autotune=flag)
    payload = ctx.to_json()
    assert json.loads(payload)["autotune"] is flag
    assert mp.PrecisionContext.from_json(payload).autotune is flag
    jctx = JCtx.from_json(payload)
    assert jctx.autotune is flag
    assert json.loads(jctx.to_json()) == json.loads(payload)


def test_tile_e_is_the_kernels_table():
    """``tile_e`` of csrc/mp_matmul.cu: the outputs per thread of the
    strided prefill tile by limbs, orders and weights (its header's 128 x
    128 tile at M8, shrinking as the accumulators grow); E / 2 the tuner's
    other choice for the built-in formats' projection; the TMA tile's
    columns beside it (``hp_bn`` of csrc/mp_matmul_hopper.cu: 96 at M8,
    narrowing with the orders)."""
    want = {("M8", 1): 64, ("M16", 1): 32, ("M23", 1): 16, ("M36", 1): 16,
            ("M52", 1): 16, ("M8", 2): 32, ("M16", 2): 16, ("M8", 3): 32,
            ("M16", 3): 8, ("M52", 3): 4}
    for (mode, n_out), e in want.items():
        assert at.format_tile_e(mode, n_out) == e
        assert at.format_tile_e_alt(mode, n_out) == (e // 2 if e >= 8 else 0)
    for mode, bn in (("M8", 96), ("M16", 64), ("M23", 48), ("M36", 32),
                     ("M52", 24)):
        assert at.tma_tile_n(mode) == bn
    register_format("X16FULL", mantissa_bits=16, n_limbs=2, max_order=2)
    try:   # the generic instantiation: (8 limbs, 15 orders), no other E
        assert at.format_tile_e("X16FULL") == 8
        assert at.format_tile_e_alt("X16FULL") == 0
        assert at.decode_ring_k("X16FULL") == 128
        assert at.tma_tile_n("X16FULL") == 8
    finally:
        unregister_format("X16FULL")


def test_smem_mirrors_pin_the_kernels_numbers():
    """The mirrors at the serving shapes; the same numbers the libraries
    export (held equal on the H100 for every format, E, stage and head
    dim by tests/test_torch_gpu.py::test_autotune_sweeps_bitwise)."""
    # the M8 prefill tile: 128 x 128, two stages of f32 staging, two plane
    # buffers; every default tile fits the card's 232448 bytes
    assert at.tile_smem(1, 1, 64) == 2 * (128 * 64 * 4 * 2) + 2 * (
        128 * 72 * 2 + 64 * 136 * 2)
    for mode in ("M8", "M16", "M23", "M36", "M52"):
        for n_out in (1, 2, 3):
            nl = {"M8": 1, "M16": 2, "M23": 3, "M36": 5, "M52": 7}[mode]
            for e in (at.format_tile_e(mode, n_out),
                      at.format_tile_e_alt(mode, n_out)):
                if e:
                    assert at.tile_smem(nl, n_out, e) <= at.SMEM_MAX
                    assert at.tile_smem(nl, n_out, e, pl=True) <= \
                        at.tile_smem(nl, n_out, e)
    # the decode tile at 8 rows, 256 k per stage, three slots, f32 weights
    assert at.dec_smem_bytes(False, 2, 8, 256, 3, 1) == (
        3 * 256 * 16 * 4 + 3 * 8 * 256 * 4 + 2 * 2 * 8 * 264 * 2
        + 2 * 2 * 256 * 16 * 2 + 16)
    # the TMA tile at M8: 1024 bytes of alignment slack, two plane buffers
    # (a 128 x 64 A plane, K-major, and a 64 x 96 B plane, N-major in two
    # 64-column atoms, bf16), two f32 stages (128 x 64 and 64 x 96; a third
    # does not fit), four mbarriers; every format's tile fits
    assert at.tma_smem("M8") == 1024 + 2 * (128 * 64 * 2 + 2 * 64 * 64 * 2) \
        + 2 * (128 + 96) * 64 * 4 + 32
    assert at.tma_smem("M8") + (128 + 96) * 64 * 4 > at.SMEM_MAX
    for mode in ("M8", "M16", "M23", "M36", "M52"):
        assert at.tma_smem(mode) <= at.SMEM_MAX
    # the split decode tile at w_down, S = 6: 8 chunks of sums a rank
    assert at.split_smem("M8", 8, 512, 256, 8) == at.dec_smem_bytes(
        False, 1, 8, 256, 2, 1) + 8 * 16 * 16 * 4
    # flash at Dh 64, M16 / M8 (f32 planes), 64 query rows
    assert at.flash_smem(64, 64, "M16", "M8") == (
        2 * 32 * 68 * 4 + 2 * 64 * 32 * 4 + 1 * 32 * 64 * 4
        + 4 * (2 * 64 * 16 * 4 + max(1 * 32 * 20 * 4, 16 * 36 * 4)))


def test_candidates_filter_by_shared_memory_and_spills():
    # the fused matmul's decode tile: (dk, S), stages of KC up to the ring
    # (256 for <= 3 limbs) and the rank's K range, cluster sizes the plan's
    # (6 at 48 slabs), 1, 2, 4 and 8 as the tile runs them (12 chunks: 6)
    assert at.candidate_blocks(8, 768, 768, "M8", smem=at.SMEM_MAX) == \
        [(64, 1), (128, 1), (192, 1), (256, 1), (64, 2), (128, 2), (192, 2),
         (256, 2), (64, 4), (128, 4), (192, 4), (64, 6), (128, 6)]
    assert at.candidate_blocks(8, 100, 768, "M8", smem=at.SMEM_MAX) == \
        [(64, 1), (128, 1), (64, 2)]
    assert at.candidate_blocks(8, 768, 768, "M36", smem=at.SMEM_MAX) == \
        [(64, 1), (128, 1), (64, 2), (128, 2), (64, 4), (128, 4), (64, 6),
         (128, 6)]
    # S = 2 at 128 k needs the 6 chunk sums beside the ring; S = 4 at 192
    # k fits (one stage of a rank's 3 chunks)
    small = at.dec_smem_bytes(False, 1, 8, 128, 3, 1)
    assert at.candidate_blocks(8, 768, 768, "M8", smem=small) == \
        [(64, 1), (128, 1), (64, 2), (64, 4), (128, 4), (192, 4), (64, 6),
         (128, 6)]
    # the projection's decode tile, split over a cluster: (dk, S) as the
    # fused matmul's; QKV's plan takes S = 4 for its 144 slabs (one weight
    # a block, 64 registers), the gated block none (a rank's stages would
    # be as many as one block's)
    split = [(64, 1), (128, 1), (192, 1), (256, 1), (64, 2), (128, 2),
             (192, 2), (256, 2), (64, 4), (128, 4), (192, 4), (64, 6),
             (128, 6)]
    assert at.candidate_blocks(8, 768, 768, "M8", n_out=3,
                               smem=at.SMEM_MAX) == split
    assert at.split_plan(144, 768, "M8") == (4, 192)
    assert at.candidate_blocks(8, 768, 3072, "M8", n_out=2,
                               epilogue="swiglu", smem=at.SMEM_MAX) == split
    assert at.split_plan(192, 768, "M8", nout=2) == (1, 0)
    # two weights' f32 rings and planes at S = 1 need more than one's
    small = at.dec_smem_bytes(False, 1, 8, 192, 3, 1)
    assert (256, 1) not in at.candidate_blocks(
        8, 768, 3072, "M8", n_out=2, epilogue="swiglu", smem=small)
    # the fused matmul's prefill tiles have no free parameter
    assert at.candidate_blocks(2048, 768, 768, "M8", smem=at.SMEM_MAX) == []
    assert at.candidate_blocks(2048, 768, 768, "M16", smem=at.SMEM_MAX) == []

    def entry(name, targs, regs, spill):   # as the H100 build reports it
        return (f"ptxas info    : Compiling entry function '_ZN45_GLOBAL__N"
                f"__73b160df_12_mp_matmul_cu_acc52c43{len(name)}{name}I"
                f"{targs}EEv' for 'sm_90a'\n    0 bytes stack frame, {spill} "
                f"bytes spill stores, {spill} bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers\n")

    # the projection's strided prefill tile (rows off 16 bytes): the
    # default E and E / 2; its TMA tile (the serving shapes) has none
    ptxas = build.ptxas_summary(
        entry("fused_proj_kernel", "Li1ELi1ELi2ELb0ELi32E", 160, 0)
        + entry("fused_proj_kernel", "Li1ELi1ELi2ELb0ELi16E", 96, 0))
    assert at.candidate_blocks(2048, 768, 3070, "M8", n_out=2,
                               epilogue="swiglu", smem=at.SMEM_MAX,
                               ptxas=ptxas) == [(0, 32), (0, 16)]
    assert at.candidate_blocks(2048, 768, 3072, "M8", n_out=2,
                               epilogue="swiglu", smem=at.SMEM_MAX,
                               ptxas=ptxas) == []
    ptxas = build.ptxas_summary(
        entry("fused_proj_kernel", "Li2ELi2ELi1ELb0ELi32E", 168, 0)
        + entry("fused_proj_kernel", "Li2ELi2ELi1ELb0ELi16E", 128, 8))
    assert at.candidate_blocks(2048, 768, 766, "M16", epilogue="bias",
                               smem=at.SMEM_MAX, ptxas=ptxas) == [(0, 32)]
    assert at.candidate_blocks(2048, 768, 768, "M16", epilogue="bias",
                               smem=at.SMEM_MAX, ptxas=ptxas) == []
    # flash: 16, 32, 64 query rows (within S rounded up to 16)
    assert at.attention_candidate_blocks(256, 256, 64, "M16", "M8",
                                         smem=at.SMEM_MAX) == \
        [(16,), (32,), (64,)]
    assert at.attention_candidate_blocks(20, 20, 64, "M16", "M8",
                                         smem=at.SMEM_MAX) == [(16,), (32,)]


def test_table_round_trip_is_atomic(table_dir):
    table = at.load_table("NVIDIA_H100_80GB_HBM3")
    assert table == {}
    table["M16|8x768x768|float32"] = [128, 0]
    table["attn|M16/M8|96x256x256x64|c1|p0"] = [64]
    path = at.save_table(table, "NVIDIA_H100_80GB_HBM3")
    assert os.path.basename(path) == "NVIDIA_H100_80GB_HBM3.v4.json"
    assert sorted(os.listdir(table_dir)) == ["NVIDIA_H100_80GB_HBM3.v4.json"]
    at.clear_memory_cache()
    assert at.load_table("NVIDIA_H100_80GB_HBM3") == table


def test_a_table_of_the_old_layout_is_not_read(table_dir, monkeypatch):
    """A table written for the old tiles' parameters (``[dk, E]``: a
    prefill key holds ``[0, 32]``, which the TMA tile cannot take) lies
    beside the new one unread: dispatch launches the default."""
    key = at.table_key(2048, 3072, 768, "M8", torch.float32)
    with open(table_dir / "NVIDIA_H100_80GB_HBM3.json", "w") as f:
        json.dump({key: [0, 32],
                   at.table_key(8, 768, 768, "M8", torch.float32): [192, 0]},
                  f)
    # nor one of the layout before the projection's TMA tile: its prefill
    # QKV key held E 16, which that tile cannot take
    with open(table_dir / "NVIDIA_H100_80GB_HBM3.v2.json", "w") as f:
        json.dump({at.table_key(2048, 768, 768, "M8", torch.float32,
                                n_out=3): [0, 16]}, f)
    # nor one of the layout before the projection's split decode tile: its
    # decode QKV key held (dk, 0) of the single-block tile
    with open(table_dir / "NVIDIA_H100_80GB_HBM3.v3.json", "w") as f:
        json.dump({at.table_key(8, 768, 768, "M8", torch.float32,
                                n_out=3): [192, 0]}, f)
    monkeypatch.setattr(at, "device_kind", lambda: "NVIDIA_H100_80GB_HBM3")
    assert at.load_table() == {}
    assert at.lookup(2048, 3072, 768, "M8") is None
    assert at.lookup(8, 768, 768, "M8", n_out=3) is None
    seen = _recorders(monkeypatch)
    n = at.stats()["lookups"]
    dispatch.dispatch(torch.ones((2048, 3072)), torch.ones((3072, 768)),
                      "M8", backend="cuda")
    assert seen["matmul"] is None
    assert at.stats()["lookups"] == n     # an empty table: no lookup


def test_autotune_returns_a_cached_winner_without_sweeping(table_dir):
    at.load_table()[at.table_key(8, 768, 768, "M8", torch.float32)] = \
        [192, 0]
    at.load_table()[at.attention_table_key(
        96, 256, 256, 64, "M16", "M8", causal=True)] = [32]
    assert at.autotune(8, 768, 768, "M8") == (192, 0)
    assert at.autotune_attention(96, 256, 256, 64, "M16", "M8") == (32,)
    assert at.lookup(8, 768, 768, "M8") == (192, 0)
    assert at.lookup(8, 768, 768, "M16") is None
    st = at.stats()
    assert st["sweeps"] == 0 and st["hits"] == 3 and len(st["hit_keys"]) == 2


def _recorders(monkeypatch):
    seen = {}

    def mm(a, b, mode, *, tune=None):
        seen["matmul"] = tune
        return torch.zeros(a.shape[:-1] + (b.shape[-1],))

    def proj(x, ws, mode, *, gate="none", biases=None, residual=None,
             tune=None):
        seen["fused"] = tune
        return torch.zeros(x.shape[:-1] + (ws[0].shape[-1],))

    def flash(q, k, v, fq, fp, *, causal=True, scale=None, q_offset=0,
              block_q=None):
        seen["flash"] = block_q
        return torch.zeros_like(q)

    monkeypatch.setattr(ops, "mp_matmul_cuda", mm)
    monkeypatch.setattr(ops, "mp_fused_proj_cuda", proj)
    monkeypatch.setattr(mp_attention, "mp_flash_attention", flash)
    monkeypatch.setattr(dispatch, "_on_card", lambda *t: True)
    return seen


def test_dispatch_passes_the_table_to_the_launch(table_dir, monkeypatch):
    seen = _recorders(monkeypatch)
    x = torch.ones((2, 4, 64))
    w = torch.ones((64, 32))
    table = at.load_table()
    table[at.table_key(8, 64, 32, "M16", torch.float32)] = [128, 0]
    table[at.table_key(8, 64, 32, "M8", torch.float32, n_out=2,
                       epilogue="swiglu")] = [64, 0]
    table[at.attention_table_key(8, 16, 16, 8, "M16", "M8",
                                 causal=True)] = [32]
    dispatch.dispatch(x, w, "M16", backend="cuda")
    dispatch.dispatch_fused(x, (w, w), "M8", gate="swiglu", backend="cuda")
    q = torch.ones((2, 16, 4, 8))
    dispatch.dispatch_attention(q, q, q, "M16", "M8", backend="cuda")
    assert seen == {"matmul": (128, 0), "fused": (64, 0), "flash": 32}
    # a miss keeps today's choice; the ref backend never reads the table
    dispatch.dispatch(x, w, "M23", backend="cuda")
    assert seen["matmul"] is None
    n = at.stats()["lookups"]
    dispatch.dispatch(x, w, "M16", backend="ref")
    assert at.stats()["lookups"] == n and at.stats()["sweeps"] == 0


def test_dispatch_sweeps_only_with_the_switch_on(table_dir, monkeypatch):
    seen = _recorders(monkeypatch)
    swept = []
    monkeypatch.setattr(at, "autotune",
                        lambda *a, **k: swept.append((a, k)) or (64, 0))
    x, w = torch.ones((8, 64)), torch.ones((64, 32))
    dispatch.dispatch(x, w, "M16", backend="cuda")
    assert not swept and seen["matmul"] is None
    monkeypatch.setenv("REPRO_MP_AUTOTUNE", "1")    # live: no re-configure
    dispatch.dispatch(x, w, "M16", backend="cuda")
    assert swept[0][0][:3] == (8, 64, 32) and seen["matmul"] == (64, 0)
    with mp.context(autotune=False):
        dispatch.dispatch(x, w, "M16", backend="cuda")
    assert len(swept) == 1


def test_cpu_tensors_never_read_the_table(table_dir, monkeypatch):
    monkeypatch.setenv("REPRO_MP_AUTOTUNE", "1")
    x, w = torch.ones((8, 64)), torch.ones((64, 32))
    out = dispatch.dispatch(x, w, "M16", backend="cuda")   # plain version
    assert torch.equal(out, x @ w)
    assert at.stats() == {"sweeps": 0, "lookups": 0, "hits": 0,
                          "hit_keys": []}
