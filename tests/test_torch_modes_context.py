"""PyTorch port: the paper's mode table (``core/modes.py``), the precision
context's JSON wire form and the memory-mapped token pipeline with its
prefetch thread, held against the JAX package (all three are host code:
equal values, equal payloads, bitwise batches)."""
import json
import threading

import numpy as np
import pytest

import repro.mp as jmp
from repro.core import modes as jmodes
from repro.core.formats import register_format as jregister
from repro.core.formats import unregister_format as junregister
from repro.data import pipeline as jpipe
import repro_torch.mp as mp
from repro_torch.core import modes as pmodes
from repro_torch.data import pipeline as ppipe


def _name(m):
    return getattr(m, "name", m)


# =========================================================================
# core/modes.py
# =========================================================================
def test_mode_table_is_jax():
    assert [m.name for m in pmodes.STATIC_MODES] == \
        [m.name for m in jmodes.STATIC_MODES]
    for pm, jm in zip(pmodes.STATIC_MODES, jmodes.STATIC_MODES):
        p, j = pmodes.MODE_TABLE[pm], jmodes.MODE_TABLE[jm]
        assert (p.name, p.mantissa_bits, p.n_limbs, p.max_order,
                p.n_products, p.rel_err_bound) == \
            (j.name, j.mantissa_bits, j.n_limbs, j.max_order, j.n_products,
             j.rel_err_bound)
        assert p is mp.resolve(p.name) and pmodes.spec(pm) is p
    assert pmodes.ModeSpec is mp.MPFormat


@pytest.mark.parametrize("n", range(0, 10))
def test_mode_for_limbs_is_jax(n):
    assert pmodes.mode_for_limbs(n).name == jmodes.mode_for_limbs(n).name


@pytest.mark.parametrize("a,b", [("M8", "M8"), ("M16", "M23"),
                                 ("AUTO", "AUTO"), ("AUTO", "M8"),
                                 ("M36", "M36"), ("M52", "M36")])
def test_validate_mode_pair_is_jax(a, b):
    try:
        want = _name(jmodes.validate_mode_pair(a, b))
    except ValueError:
        with pytest.raises(ValueError, match="mode-select error"):
            pmodes.validate_mode_pair(a, b)
        return
    assert _name(pmodes.validate_mode_pair(a, b)) == want


def test_facade_exports_the_mode_table():
    for name in ("MODE_TABLE", "STATIC_MODES", "spec", "mode_for_limbs",
                 "validate_mode_pair"):
        assert getattr(mp, name) is getattr(pmodes, name)


# =========================================================================
# PrecisionContext.to_json / from_json
# =========================================================================
def _with_format(name, **kw):
    mp.register_format(name, **kw)
    jregister(name, **kw)


def _drop_format(name):
    for drop in (mp.unregister_format, junregister):
        try:
            drop(name)
        except KeyError:
            pass


def test_context_json_embeds_custom_candidate_formats():
    """tests/test_mp_api.py's case on the port: a context naming a custom
    AUTO candidate hydrates where the format was never registered."""
    mp.register_format("X14", mantissa_bits=14, n_limbs=2, max_order=1)
    try:
        ctx = mp.PrecisionContext(auto_candidates=("M8", "X14"))
        payload = ctx.to_json()
        mp.unregister_format("X14")          # a fresh process
        ctx2 = mp.PrecisionContext.from_json(payload)
        assert tuple(ctx2.auto_candidates) == ("M8", "X14")
        assert mp.resolve("X14").mantissa_bits == 14   # re-registered
    finally:
        mp.unregister_format("X14")


def test_port_payload_is_the_jax_wire_form_both_ways():
    """A port context (the ``ref`` backend, which both packages have) reads
    in JAX, and JAX's payload reads in the port, with the policy and a
    custom candidate's definition; the port writes ``autotune`` null."""
    _with_format("X19", mantissa_bits=19, n_limbs=3, max_order=1)
    try:
        pol = mp.PrecisionPolicy({"ffn": {"fwd": "M8", "wgrad": "M23"},
                                  "qkv": "AUTO"}, bwd_dgrad="M16")
        pctx = mp.PrecisionContext(backend="ref", policy=pol,
                                   auto_candidates=("M8", "X19"),
                                   auto_tol=2.0 ** -11)
        payload = pctx.to_json()
        assert json.loads(payload)["autotune"] is None
        assert json.loads(payload)["formats"]["X19"]["n_limbs"] == 3
        jctx = jmp.PrecisionContext.from_json(payload)
        assert jctx.backend == "ref" and jctx.autotune is None
        assert tuple(jctx.auto_candidates) == ("M8", "X19")
        assert jctx.auto_tol == 2.0 ** -11
        assert json.loads(jctx.policy.to_json()) == json.loads(pol.to_json())
        jpayload = jctx.to_json()
        assert json.loads(jpayload) == json.loads(payload)
        back = mp.PrecisionContext.from_json(jpayload)
        assert back.policy == pol and back.auto_tol == 2.0 ** -11
        assert tuple(back.auto_candidates) == ("M8", "X19")
        assert json.loads(back.to_json()) == json.loads(payload)
    finally:
        _drop_format("X19")


@pytest.mark.parametrize("autotune,ok", [(None, True), (False, True),
                                         (True, True)])
def test_from_json_takes_autotune_off_only(autotune, ok):
    """JAX's payload with the switch null, off or on reads in the port with
    the same switch (the port has the autotuner now), and writes back the
    same payload."""
    payload = jmp.PrecisionContext(backend="ref",
                                   autotune=autotune).to_json()
    assert ok
    ctx = mp.PrecisionContext.from_json(payload)
    assert ctx.backend == "ref" and ctx.autotune is autotune
    assert json.loads(ctx.to_json()) == json.loads(payload)


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret"])
def test_from_json_names_the_jax_only_backends(backend):
    payload = jmp.PrecisionContext(backend=backend).to_json()
    with pytest.raises(ValueError, match="JAX package's"):
        mp.PrecisionContext.from_json(payload)
    with pytest.raises(ValueError, match="JAX package's"):
        mp.configure(backend=backend)


def test_sharded_context_round_trips_from_jax():
    """JAX's ``PrecisionContext(backend="sharded")`` payload hydrates in the
    port (which has the sharded backend), and back; the mesh is
    process-local and stays out of the JSON in both packages."""
    pol = mp.PrecisionPolicy({"ffn": "M8"})
    payload = jmp.PrecisionContext(
        backend="sharded", policy=jmp.PrecisionPolicy.from_json(
            pol.to_json())).to_json()
    ctx = mp.PrecisionContext.from_json(payload)
    assert ctx.backend == "sharded" and ctx.mesh is None
    assert ctx.policy == pol
    assert "mesh" not in json.loads(ctx.to_json())
    assert json.loads(ctx.to_json()) == json.loads(payload)
    assert jmp.PrecisionContext.from_json(ctx.to_json()).backend == "sharded"
    with mp.context(backend="sharded"):
        assert mp.current_context().backend == "sharded"


def test_context_from_json_validates_payload():
    """tests/test_mp_api.py's parse-time validation on the port."""
    with pytest.raises(ValueError, match="unknown backend"):
        mp.PrecisionContext.from_json('{"backend": "bogus"}')
    with pytest.raises(KeyError, match="M99"):
        mp.PrecisionContext.from_json('{"auto_candidates": ["M99"]}')
    ctx = mp.PrecisionContext.from_json("{}")
    assert ctx == mp.PrecisionContext()      # the port's defaults
    assert mp.PrecisionContext.from_json(
        {"backend": "cuda"}).backend == "cuda"


# =========================================================================
# MemmapLM and Prefetcher
# =========================================================================
def _token_file(tmp_path, n=5000, vocab=1000, seed=0):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(seed).integers(0, vocab, n).astype(
        np.uint32).tofile(path)
    return str(path)


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2), (3, 4)])
def test_memmap_batches_are_bitwise_jax(tmp_path, rank, world):
    kw = dict(vocab=1000, seq_len=33, global_batch=8, kind="memmap",
              path=_token_file(tmp_path))
    j = jpipe.make_pipeline(jpipe.DataConfig(**kw))
    p = ppipe.make_pipeline(ppipe.DataConfig(**kw))
    assert isinstance(p, ppipe.MemmapLM)
    for step in (0, 1, 7, 50, 1000):
        jb, pb = j.batch(step, rank, world), p.batch(step, rank, world)
        assert jb.keys() == pb.keys()
        for k in jb:
            assert jb[k].dtype == pb[k].dtype
            np.testing.assert_array_equal(jb[k], pb[k])


def test_memmap_needs_a_path():
    with pytest.raises(ValueError, match="path"):
        ppipe.MemmapLM(ppipe.DataConfig(vocab=10, seq_len=5,
                                        global_batch=2, kind="memmap"))


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "repro_torch-prefetch"]


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetcher_keeps_step_order_and_closes(tmp_path, depth):
    pipe = ppipe.MemmapLM(ppipe.DataConfig(
        vocab=1000, seq_len=17, global_batch=4, kind="memmap",
        path=_token_file(tmp_path)))
    before = len(_prefetch_threads())
    pf = ppipe.Prefetcher(pipe, start_step=5, depth=depth)
    got = [next(pf) for _ in range(6)]
    assert [s for s, _ in got] == list(range(5, 11))
    for step, batch in got:
        want = pipe.batch(step)
        for k in want:
            np.testing.assert_array_equal(batch[k], want[k])
    pf.close()
    assert len(_prefetch_threads()) == before


def test_prefetcher_closes_with_a_full_queue_and_raises_errors():
    class Flaky:
        def batch(self, step, rank=0, world=1):
            if step == 2:
                raise IndexError("no such window")
            return {"tokens": np.full((1, 2), step)}

    before = len(_prefetch_threads())
    pf = ppipe.Prefetcher(Flaky(), depth=1)
    assert next(pf)[0] == 0 and next(pf)[0] == 1
    with pytest.raises(IndexError, match="no such window"):
        next(pf)
    pf.close()
    blocked = ppipe.Prefetcher(ppipe.SyntheticLM(ppipe.DataConfig(
        vocab=50, seq_len=9, global_batch=2)), depth=1)
    blocked.close()   # its thread waits on a full queue: it still stops
    assert len(_prefetch_threads()) == before
