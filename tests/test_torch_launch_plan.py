"""The launch side of the Hopper tiles (the fused matmul's, the
projection's TMA tile, the split tiles of the projection and of the
pre-limbed and mixed-lane matmuls) and the autotuner,
without a card: the sweep keeps the fastest of all configurations, the
default launch among them (``repro.kernels.autotune.autotune`` keeps the
fastest of its candidates, its default blocks among them); a default table
entry reaches the launch entry as zeros with no other call into the
library, a tuned one as the entry's arguments; the route each operand
layout takes; and the Python mirrors of the decode plan (on f32 weights,
one or more a block, and on stored planes) and the TMA tile pinned at the
serving shapes
(``tests/test_torch_gpu.py`` holds them equal to the numbers the library
exports, on the card)."""
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch import kernels
from repro_torch.core.formats import resolve
from repro_torch.kernels import autotune as at
from repro_torch.kernels import build, mp_matmul as mm, timing


# ---------------------------------------------------------------------------
# the sweep's choice
# ---------------------------------------------------------------------------
def _timed(monkeypatch, ms_by_config):
    """A device timer that reads each configuration's time from the name
    the run returns (the run's output is its configuration's tag)."""
    current = {}

    def fake_device_ms(fn, min_ms=30.0):
        fn()
        return ms_by_config[current["cfg"]], True
    monkeypatch.setattr(timing, "device_ms", fake_device_ms)
    return current


def _run(current):
    def run(cfg):
        current["cfg"] = None if cfg is None else tuple(cfg)
        return torch.zeros(4)           # every launch gives the same bits
    return run


@pytest.mark.parametrize("times,want", [
    ({None: 1.0, (64, 2): 1.5, (128, 6): 1.2}, (0, 0)),
    ({None: 1.0, (64, 2): 0.7, (128, 6): 0.9}, (64, 2)),
    ({None: 1.0, (64, 2): 1.0, (128, 6): 1.0}, (0, 0)),   # a tie: default
])
def test_sweep_keeps_the_fastest_default_included(monkeypatch, times, want):
    current = _timed(monkeypatch, times)
    rec = {}
    got = at._sweep("k", [(64, 2), (128, 6)], _run(current), 3, rec, (0, 0))
    assert got == want
    assert rec["winner"] == list(want)
    assert rec["default_won"] == (want == (0, 0))
    assert rec["winner_ms"] <= rec["default_ms"]


@pytest.mark.parametrize("times", [
    (0.9, 1.1, 0.95), (1.0, 0.8, 0.7), (1.0, 1.0, 1.0), (1.2, 0.9, 0.9)])
def test_the_sweep_chooses_as_jax_does(monkeypatch, times):
    """JAX's ``autotune`` times its candidates, its default blocks first
    among them, and keeps the first of the least times; on the same times
    the port's sweep keeps the same configuration."""
    jcands = [(0, 0, 0), (64, 1, 0), (128, 2, 0)]
    by = dict(zip(jcands, times))
    monkeypatch.setattr(jat, "_time_blocks", lambda a, b, mode, cand, **k:
                        by[tuple(cand)])
    monkeypatch.setattr(jat, "load_table", lambda *a: {})
    monkeypatch.setattr(jat, "save_table", lambda *a, **k: None)
    want = jat.autotune(8, 16, 16, "M8", candidates=jcands)
    current = _timed(monkeypatch, {None: times[0], (64, 1): times[1],
                                   (128, 2): times[2]})
    got = at._sweep("k", [(64, 1), (128, 2)], _run(current), 1, None, (0, 0))
    assert got == tuple(want)[:2]


def test_a_cell_without_candidates_keeps_the_default(monkeypatch):
    """A prefill tile's key: no candidate, the default timed alone."""
    current = _timed(monkeypatch, {None: 0.25})
    rec = {}
    assert at._sweep("k", [], _run(current), 3, rec, (0, 0)) == (0, 0)
    assert rec["default_won"] and rec["candidates"] == {}
    assert rec["winner_ms"] == rec["default_ms"] == 0.25


def test_attention_sweep_stores_its_default_block(monkeypatch):
    current = _timed(monkeypatch, {None: 0.5, (16,): 0.6, (32,): 0.8})
    assert at._sweep("a", [(16,), (32,)], _run(current), 2, None,
                     (64,)) == (64,)


def test_sweep_raises_on_a_candidate_that_changes_bits(monkeypatch):
    _timed(monkeypatch, {None: 1.0, (64, 1): 1.0})

    def run(cfg):
        return torch.ones(3) if cfg is None else torch.zeros(3)
    with pytest.raises(RuntimeError, match="differs from the default"):
        at._sweep("k", [(64, 1)], run, 1, None, (0, 0))


# ---------------------------------------------------------------------------
# launch parameters as launch arguments
# ---------------------------------------------------------------------------
class _Entry:
    def __init__(self, lib, name):
        self.lib, self.name = lib, name
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.lib.calls.append((self.name, args))
        return 0


class _FakeLib:
    """Records every call into a C entry (setting argtypes is no call)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mp_"):
            raise AttributeError(name)
        entry = _Entry(self, name)
        setattr(self, name, entry)
        return entry


@pytest.fixture
def fake_libs(monkeypatch):
    libs = {"mp_matmul": _FakeLib(), "mp_matmul_hopper": _FakeLib()}
    monkeypatch.setattr(build, "load", lambda name: libs[name])
    return libs


@pytest.mark.parametrize("M", [8, 64])
@pytest.mark.parametrize("tune", [None, (0, 0)])
def test_a_default_entry_makes_no_parameter_call(fake_libs, M, tune):
    """A ``[0, 0]`` table entry (or none) reaches the launch as zeros: one
    call into the library, the launch itself."""
    a, b = torch.ones((M, 64)), torch.ones((64, 32))
    _, route = mm.launch_routed(0, a, b, resolve("M16"), tune)
    assert route == (mm.SPLIT if M <= 16 else mm.TMA)
    calls = fake_libs["mp_matmul_hopper"].calls
    assert [name for name, _ in calls] == ["mp_hopper_matmul_launch"]
    assert calls[0][1][-3:-1] == (0, 0)
    assert fake_libs["mp_matmul"].calls == []


def test_tuned_parameters_travel_in_the_launch_arguments(fake_libs):
    a, b = torch.ones((8, 3072)), torch.ones((3072, 768))
    mm.launch_routed(0, a, b, resolve("M8"), (128, 6))
    ((name, args),) = fake_libs["mp_matmul_hopper"].calls
    assert name == "mp_hopper_matmul_launch" and args[-3:-1] == (128, 6)
    ws = [torch.ones((64, 32)) for _ in range(2)]
    mm.launch_proj_routed(0, torch.ones((8, 64)), ws, resolve("M8"),
                          gate="swiglu", tune=(64, 2))
    (_, (name, args)) = fake_libs["mp_matmul_hopper"].calls
    assert name == "mp_hopper_proj_decode_launch" and args[-3:-1] == (64, 2)
    mm.launch_mixed_routed(0, torch.ones((8, 64)),
                           torch.zeros((2, 64, 32), dtype=torch.bfloat16),
                           resolve("M23"), *_lanes(8), (128, 4))
    (name, args) = fake_libs["mp_matmul_hopper"].calls[-1]
    assert name == "mp_hopper_mixed_prelimbed_launch" and \
        args[-3:-1] == (128, 4)
    assert fake_libs["mp_matmul"].calls == []


@pytest.mark.parametrize("transposed", [False, True])
def test_the_strided_tile_takes_no_parameter(fake_libs, transposed):
    """Neither prefill tile (the TMA tile, or the strided tile a transposed
    view runs) has a free parameter: a tuned entry raises before any call
    into a library, the default launches."""
    a = torch.ones((64, 96))
    b = torch.ones((32, 96)).t() if transposed else torch.ones((96, 32))
    with pytest.raises(ValueError, match="takes no launch parameters"):
        mm.launch_routed(0, a, b, resolve("M8"), (0, 3))
    assert fake_libs["mp_matmul"].calls == []
    assert fake_libs["mp_matmul_hopper"].calls == []
    _, route = mm.launch_routed(0, a, b, resolve("M8"), (0, 0))
    assert route == (mm.STRIDED if transposed else mm.TMA)
    lib = "mp_matmul" if transposed else "mp_matmul_hopper"
    assert len(fake_libs[lib].calls) == 1


@pytest.mark.parametrize("mode", ["M8", "M23"])
def test_partials_take_the_same_routes(fake_libs, mode):
    """The partials epilogue takes the fused matmul's routes, but at more
    than one limb its prefill keeps the strided tile (faster there)."""
    fmt = resolve(mode)
    for M, route in ((8, mm.SPLIT),
                     (64, mm.TMA if fmt.n_limbs == 1 else mm.STRIDED)):
        out, got = mm.launch_routed(0, torch.ones((M, 64)),
                                    torch.ones((64, 32)), fmt, parts=True)
        assert got == route and out.shape == (fmt.n_orders, M, 32)
    calls = fake_libs["mp_matmul_hopper"].calls
    assert len(calls) == (2 if fmt.n_limbs == 1 else 1)
    ((name, args),) = calls[-1:]
    assert args[16] == 1    # parts
    if fmt.n_limbs == 1:
        assert args[15] == out.stride(0)    # c_so
    else:
        assert [n for n, _ in fake_libs["mp_matmul"].calls] == \
            ["mp_fused_matmul_partials_launch"]


def test_launch_params_and_the_thread_locals_are_gone():
    assert not hasattr(mm, "launch_params")
    src = (build.CSRC / "mp_matmul.cu").read_text() + \
        (build.CSRC / "mp_matmul_common.cuh").read_text()
    assert "mp_set_launch_params" not in src and "thread_local" not in src


def test_reset_zeroes_the_route_counters():
    mm.mp_fused_matmul.routes[mm.TMA] += 3
    mm.mp_fused_matmul_partials.routes[mm.SPLIT] += 1
    mm.mp_fused_proj.routes[mm.SPLIT] += 2
    mm.mp_prelimbed_matmul.routes[mm.SPLIT] += 5
    mm.mp_mixed_prelimbed_matmul.routes[mm.SPLIT] += 7
    mm.mp_mixed_prelimbed_matmul.routes[mm.MMA] += 1
    mm.mp_both_prelimbed_matmul.routes[mm.TMA] += 4
    mm.mp_both_prelimbed_matmul.routes[mm.MMA] += 2
    kernels.reset_launch_counts()
    assert kernels.route_counts() == {
        "mp_fused_matmul": dict.fromkeys(mm.ROUTES, 0),
        "mp_fused_proj": dict.fromkeys(mm.PROJ_ROUTES, 0),
        "mp_prelimbed_matmul": dict.fromkeys(mm.PRELIMBED_ROUTES, 0),
        "mp_mixed_prelimbed_matmul": dict.fromkeys(mm.PRELIMBED_ROUTES, 0),
        "mp_both_prelimbed_matmul": dict.fromkeys(mm.BOTH_ROUTES, 0),
        "mp_fused_matmul_partials": dict.fromkeys(mm.ROUTES, 0)}
    assert mm.PROJ_ROUTES == (mm.SPLIT, mm.TMA, mm.STRIDED)


# ---------------------------------------------------------------------------
# routes by layout
# ---------------------------------------------------------------------------
def _route(a, b):
    a, b, _, sizes, strides = mm._marshal(a, b)
    return mm.fused_route(a, b, sizes, strides)


@pytest.mark.parametrize("case,want", [
    ("decode", mm.SPLIT),
    ("contiguous", mm.TMA),
    ("ragged, rows of 16 bytes", mm.TMA),
    ("batched, two dims", mm.TMA),
    ("batched, token broadcast (stride 0)", mm.STRIDED),
    ("transposed B (dgrad's W^T view)", mm.STRIDED),
    ("row stride off 16 bytes", mm.STRIDED),
    ("base off 16 bytes", mm.STRIDED),
    ("decode, transposed", mm.SPLIT),
])
def test_routes_by_layout(case, want):
    r = torch.ones
    a, b = {
        "decode": (r(8, 64), r(64, 32)),
        "contiguous": (r(2048, 768), r(768, 768)),
        "ragged, rows of 16 bytes": (r(130, 200), r(200, 72)),
        "batched, two dims": (r(2, 3, 40, 64), r(2, 3, 64, 48)),
        "batched, token broadcast (stride 0)": (r(40, 64).expand(5, 40, 64),
                                                r(5, 64, 48)),
        "transposed B (dgrad's W^T view)": (r(70, 96), r(32, 96).t()),
        "row stride off 16 bytes": (r(130, 200), r(200, 70)),
        "base off 16 bytes": (r(64, 97)[:, 1:], r(96, 32)),
        "decode, transposed": (r(64, 8).t(), r(64, 32)),
    }[case]
    assert _route(a, b) == want


# ---------------------------------------------------------------------------
# the plan and the tile, pinned
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("slabs,K,mode,want", [
    (48, 3072, "M8", (8, 128)),    # w_down 8x3072x768: 384 blocks, 6 chunks
    (48, 768, "M8", (6, 128)),     # wo: 288 blocks of 2 chunks
    (48, 768, "M16", (6, 128)),
    (48, 3072, "M52", (1, 0)),     # seven orders' sums do not fit 8 ranks
    (192, 768, "M8", (3, 128)),    # w_gate 8x768x3072
    (2000, 768, "M16", (1, 0)),    # lm_head: the slabs fill the card
    (96 * 32, 64, "M16", (1, 0)),  # decode QK, 96 batch entries
    (4, 64, "M8", (1, 0)),         # one chunk
    (10, 320, "M8", (5, 64)),      # 5 chunks: one each
    (20, 448, "M8", (7, 64)),      # 7 chunks, 8 asked: one each
])
def test_split_plan(slabs, K, mode, want):
    assert at.split_plan(slabs, K, mode) == want
    S, dk = want
    if S > 1:   # every block fits on the card at once
        cpr = -(-(-(-K // at.KC)) // S)
        smem = at.split_smem(mode, 8, cpr * at.KC, dk, cpr)
        per_sm = min(at.H100_SM_SMEM // (smem + 1024), at.split_per_sm())
        assert S * slabs <= per_sm * at.H100_SMS


@pytest.mark.parametrize("K,s,want", [(3072, 8, 8), (768, 8, 6), (768, 5, 4),
                                      (100, 8, 2), (64, 4, 1), (640, 3, 3)])
def test_split_norm_gives_every_rank_a_chunk(K, s, want):
    got = at.split_norm(K, s)
    assert got == want
    nch = -(-K // at.KC)
    cpr = -(-nch // got)
    assert (got - 1) * cpr < nch <= got * cpr


def test_split_shared_memory_pins():
    # w_down at S = 6: a rank's 512 k at 256 a stage, two slots, 8 chunk
    # sums of 16 x 16 f32 at one order
    base = at.dec_smem_bytes(False, 1, 8, 256, 2, 1)
    assert at.split_smem("M8", 8, 512, 256, 8) == \
        -(-base // 16) * 16 + 8 * 1 * 256 * 4
    # M52's seven orders at 6 chunks
    assert at.split_smem("M52", 8, 384, 128, 6) - at.split_smem(
        "M52", 8, 384, 128, 0) == 6 * 7 * 1024


@pytest.mark.parametrize("mode,bn,stages,smem", [
    ("M8", 96, 2, 1024 + 2 * (16384 + 16384) + 2 * 57344 + 32),
    ("M16", 64, 2, 1024 + 2 * 49152 + 2 * 49152 + 32),
    ("M23", 48, 2, 1024 + 2 * 67584 + 2 * 45056 + 32),
    ("M36", 32, 3, 1024 + 1 * 102400 + 3 * 40960 + 32),
    ("M52", 24, 2, 1024 + 1 * 136192 + 2 * 38912 + 32),
])
def test_tma_tile_pins(mode, bn, stages, smem):
    """Columns and shared memory at the tile's f32 stages: three where
    they fit, else two."""
    assert at.tma_tile_n(mode) == bn
    assert at.tma_smem(mode) == smem <= at.SMEM_MAX
    assert stages == 3 or smem + at._tma_stage(bn) > at.SMEM_MAX


def test_tma_tiles_fill_the_card_at_the_serving_prefill():
    """2048 x 768 outputs at M8 make 128 tiles of 128 x 96 for 132 SMs."""
    bn = at.tma_tile_n("M8")
    assert (2048 // at.HM) * (768 // bn) == 128
    assert at.tma_tile_n("M16") == 64


def test_generic_format_takes_the_narrowest_tile():
    from repro_torch.core.formats import register_format, unregister_format

    register_format("X16PL", mantissa_bits=16, n_limbs=2, max_order=2)
    try:
        assert at.tma_tile_n("X16PL") == 8
        # one plane buffer of 8 limbs, two f32 stages (a third does not fit)
        assert at.tma_smem("X16PL") == 1024 + 8 * (16384 + 1024) + \
            2 * 136 * 64 * 4 + 32
    finally:
        unregister_format("X16PL")


def test_candidates_cover_the_plan_and_every_cluster_size():
    cands = at.candidate_blocks(8, 3072, 768, "M8", smem=at.SMEM_MAX)
    assert {s for _, s in cands} == {1, 2, 4, 8}
    assert {dk for dk, _ in cands} == {64, 128, 192, 256}
    for dk, s in cands:
        assert s == at.split_norm(3072, s) and dk % at.KC == 0
    # the prefill tiles have no free parameter
    assert at.candidate_blocks(2048, 3072, 768, "M8", smem=at.SMEM_MAX) == []
    assert at.candidate_blocks(2048, 768, 32000, "M16",
                               smem=at.SMEM_MAX) == []


# ---------------------------------------------------------------------------
# the projection's and the pre-limbed matmul's routes
# ---------------------------------------------------------------------------
def _misaligned(rows, cols):
    """A contiguous (rows, cols) f32 tensor whose base is 4 bytes off 16."""
    return torch.ones(rows * cols + 1)[1:].view(rows, cols)


@pytest.mark.parametrize("case,want,entry", [
    ("contiguous", mm.TMA, "mp_hopper_proj_launch"),
    ("gated", mm.TMA, "mp_hopper_proj_launch"),
    ("N % 4 != 0", mm.STRIDED, "mp_fused_proj_launch"),
    ("K % 4 != 0", mm.STRIDED, "mp_fused_proj_launch"),
    ("misaligned base", mm.STRIDED, "mp_fused_proj_launch"),
    ("M <= 16", mm.SPLIT, "mp_hopper_proj_decode_launch"),
    ("M <= 16, gated", mm.SPLIT, "mp_hopper_proj_decode_launch"),
    ("M <= 16, rows off 16 bytes", mm.SPLIT, "mp_hopper_proj_decode_launch"),
])
def test_projection_routes_by_layout(fake_libs, case, want, entry):
    """The projection's TMA tile takes the operands a tensor map reads;
    rows off 16 bytes or a misaligned base keep the strided tile; M <= 16
    the split decode tile (its cp.async copies take any layout) whatever
    the layout.  One call into one library."""
    r = torch.ones
    a, ws, gate = {
        "contiguous": (r(64, 96), [r(96, 32)] * 3, "none"),
        "gated": (r(64, 96), [r(96, 32)] * 2, "swiglu"),
        "N % 4 != 0": (r(64, 96), [r(96, 30)] * 3, "none"),
        "K % 4 != 0": (r(64, 94), [r(94, 32)] * 2, "none"),
        "misaligned base": (_misaligned(64, 96), [r(96, 32)] * 3, "none"),
        "M <= 16": (r(8, 96), [r(96, 32)] * 3, "none"),
        "M <= 16, gated": (r(16, 96), [r(96, 32)] * 2, "swiglu"),
        "M <= 16, rows off 16 bytes": (r(8, 94), [r(94, 30)] * 3, "none"),
    }[case]
    out, route = mm.launch_proj_routed(0, a, ws, resolve("M8"), gate=gate)
    assert route == want
    assert out.shape == ((a.shape[0], 32) if gate != "none" else
                         (len(ws), a.shape[0], ws[0].shape[1]))
    calls = [n for lib in fake_libs.values() for n, _ in lib.calls]
    assert calls == [entry]


def test_the_projections_tma_tile_takes_no_parameter(fake_libs):
    """A prefill projection key on the TMA route carries no parameter: a
    tuned one raises before any call, the default launches; the decode and
    strided tiles take theirs."""
    a, ws = torch.ones((64, 96)), [torch.ones((96, 32))] * 3
    with pytest.raises(ValueError, match="takes no launch parameters"):
        mm.launch_proj_routed(0, a, ws, resolve("M8"), tune=(0, 16))
    assert all(lib.calls == [] for lib in fake_libs.values())
    mm.launch_proj_routed(0, a, ws, resolve("M8"), tune=(0, 0))
    ((name, args),) = fake_libs["mp_matmul_hopper"].calls
    assert name == "mp_hopper_proj_launch" and len(args) == 20
    mm.launch_proj_routed(0, a, [torch.ones((96, 30))] * 3, resolve("M8"),
                          tune=(0, 16))
    mm.launch_proj_routed(0, a[:8], ws, resolve("M8"), tune=(128, 4))
    assert [args[-3:-1] for _, args in fake_libs["mp_matmul"].calls] == \
        [(0, 16)]
    (name, args) = fake_libs["mp_matmul_hopper"].calls[-1]
    assert name == "mp_hopper_proj_decode_launch" and args[-3:-1] == (128, 4)
    # the autotuner offers the TMA shapes nothing, the strided ones E
    assert at.candidate_blocks(2048, 768, 768, "M8", n_out=3,
                               smem=at.SMEM_MAX) == []
    assert at.candidate_blocks(2048, 768, 3072, "M8", n_out=2,
                               epilogue="swiglu", smem=at.SMEM_MAX) == []
    assert at.candidate_blocks(2048, 768, 770, "M8", n_out=2,
                               epilogue="swiglu", smem=at.SMEM_MAX) == \
        [(0, 32), (0, 16)]


@pytest.mark.parametrize("M,want,entry", [
    (1, mm.SPLIT, "mp_hopper_prelimbed_launch"),
    (8, mm.SPLIT, "mp_hopper_prelimbed_launch"),
    (16, mm.SPLIT, "mp_hopper_prelimbed_launch"),
    (17, mm.MMA, "mp_prelimbed_matmul_launch"),
    (70, mm.MMA, "mp_prelimbed_matmul_launch"),
])
def test_prelimbed_routes_by_rows(fake_libs, M, want, entry):
    """The pre-limbed matmul: the split decode tile (its stored planes by
    TMA where a map reads them) at M <= 16, the mma.sync tile above; the
    split tile takes the plan's launch as zeros."""
    limbs = torch.zeros((2, 96, 40), dtype=torch.bfloat16)
    out, route = mm.launch_prelimbed_routed(0, torch.ones((M, 96)), limbs,
                                            resolve("M8"))
    assert route == want == mm.prelimbed_route(torch.ones((M, 96)))
    assert out.shape == (M, 40)
    ((name, args),) = [c for lib in fake_libs.values() for c in lib.calls]
    assert name == entry
    if want == mm.SPLIT:
        assert args[-3:-1] == (0, 0) and args[5] == 2   # the stored count
    with pytest.raises(ValueError, match="takes no launch parameters"):
        mm.launch_prelimbed_routed(0, torch.ones((70, 96)), limbs,
                                   resolve("M8"), (64, 2))


def _lanes(M, modes=("M8", "M16", "M23", "M16FULL")):
    """(M,) int32 lanes of rows at ``modes`` in turn."""
    from repro_torch.core.formats import register_format

    register_format("M16FULL", mantissa_bits=16, n_limbs=2, max_order=2)
    fmts = [resolve(m) for m in (list(modes) * M)[:M]]
    return (torch.tensor([f.n_limbs for f in fmts], dtype=torch.int32),
            torch.tensor([f.max_order for f in fmts], dtype=torch.int32))


@pytest.mark.parametrize("M,want,entry", [
    (1, mm.SPLIT, "mp_hopper_mixed_prelimbed_launch"),
    (4, mm.SPLIT, "mp_hopper_mixed_prelimbed_launch"),
    (16, mm.SPLIT, "mp_hopper_mixed_prelimbed_launch"),
    (17, mm.MMA, "mp_mixed_prelimbed_matmul_launch"),
    (70, mm.MMA, "mp_mixed_prelimbed_matmul_launch"),
])
def test_mixed_routes_by_rows(fake_libs, M, want, entry):
    """The mixed-lane matmul takes the pre-limbed matmul's routes: the
    split decode tile at M <= 16 (the lanes in the arguments, the plan's
    launch as zeros), the mma.sync tile above; the wrapper counts each
    launch on its route."""
    limbs = torch.zeros((3, 96, 40), dtype=torch.bfloat16)
    ln, lo = _lanes(M)
    a = torch.ones((M, 96))
    out, route = mm.launch_mixed_routed(0, a, limbs, resolve("M23"), ln, lo)
    assert route == want == mm.prelimbed_route(a) and out.shape == (M, 40)
    ((name, args),) = [c for lib in fake_libs.values() for c in lib.calls]
    assert name == entry
    assert args[6:8] == (ln.data_ptr(), lo.data_ptr())
    if want == mm.SPLIT:
        assert args[-3:-1] == (0, 0) and args[-5:-3] == (3, 2)
    with pytest.raises(ValueError, match="takes no launch parameters"):
        mm.launch_mixed_routed(0, torch.ones((70, 96)), limbs,
                               resolve("M23"), *_lanes(70), (64, 2))
    with pytest.raises(ValueError, match="lanes must be"):
        mm.launch_mixed_routed(0, a, limbs, resolve("M23"), ln[:-1] if M > 1
                               else ln.long(), lo)


def test_the_mixed_wrapper_counts_its_routes(fake_libs, monkeypatch):
    """On CUDA tensors the wrapper launches by the route and counts it
    (the fake libraries stand in for the card: the stream and the device
    check are bypassed)."""
    monkeypatch.setattr(mm, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(mm, "_cuda_stream", lambda *t: 0)
    kernels.reset_launch_counts()
    limbs = torch.zeros((3, 96, 40), dtype=torch.bfloat16)
    for M in (8, 8, 70):
        mm.mp_mixed_prelimbed_matmul(torch.ones((M, 96)), limbs, "M23",
                                     *_lanes(M))
    assert kernels.route_counts()["mp_mixed_prelimbed_matmul"] == {
        mm.SPLIT: 2, mm.MMA: 1}
    assert kernels.launch_counts()["mp_mixed_prelimbed_matmul"] == 3
    kernels.reset_launch_counts()


@pytest.mark.parametrize("slabs,K,mode,want", [
    (48, 3072, "M8", (8, 256)),    # w_down: 384 blocks, 2 stages a rank
    (48, 3072, "M16", (8, 128)),
    (48, 768, "M8", (6, 128)),     # wq / wk / wv / wo: one stage a rank
    (48, 768, "M16", (6, 128)),
    (192, 768, "M8", (4, 192)),    # w_gate / w_up: 768 blocks
    (192, 768, "M16", (4, 64)),
    (2000, 768, "M8", (1, 0)),     # lm_head: the slabs fill the card
    (2000, 768, "M16", (1, 0)),
])
def test_split_plan_on_stored_planes(slabs, K, mode, want):
    """The plan with stored planes reckons their bf16 ring (and the TMA
    ring's slack) and 8 blocks an SM by registers (the kernel's 128
    threads), so w_up splits in 4 where the f32 weight splits in 3."""
    assert at.split_plan(slabs, K, mode, pl=True) == want
    S, dk = want
    if S > 1:
        cpr = -(-(-(-K // at.KC)) // S)
        smem = at.split_smem(mode, 8, cpr * at.KC, dk, cpr, pl=True)
        per_sm = min(at.H100_SM_SMEM // (smem + 1024), at.split_per_sm(True))
        assert S * slabs <= per_sm * at.H100_SMS
    assert at.split_per_sm(True) == 8 and at.split_per_sm(False) == 5


@pytest.mark.parametrize("slabs,K,mode,nout,want", [
    (3 * 48, 768, "M8", 1, (4, 192)),   # QKV 8x768, one weight a block:
                                        # 576 blocks of 3 chunks
    (48, 768, "M8", 3, (6, 128)),       # QKV's three weights a block
    (192, 768, "M8", 2, (1, 0)),        # SwiGLU 8x768 vs 2x768x3072: at
                                        # S = 2 a rank's 64-k stages are
                                        # as many as one block's 128-k
    (48, 768, "M8", 1, (6, 128)),       # one weight with its residual
    (3 * 48, 768, "M16", 1, (4, 64)),
    (192, 768, "M16", 2, (1, 0)),
    (3 * 48, 768, "M23", 1, (3, 64)),
])
def test_split_plan_with_weights_a_block(slabs, K, mode, nout, want):
    """The projection's plan reckons nout weights' f32 rings, limb planes
    and chunk sums a block, and every slab of every block of weights
    (grid.y); on f32 weights a rank runs fewer stages than one block
    would."""
    assert at.split_plan(slabs, K, mode, nout=nout) == want
    S, dk = want
    if S == 1:
        return
    cpr = -(-(-(-K // at.KC)) // S)
    smem = at.split_smem(mode, 8, cpr * at.KC, dk, cpr, nout=nout)
    per_sm = min(at.H100_SM_SMEM // (smem + 1024), at.split_per_sm())
    assert S * slabs <= per_sm * at.H100_SMS
    assert smem == at.split_smem(mode, 8, cpr * at.KC, dk, cpr) + (
        at.dec_smem_bytes(False, resolve(mode).n_limbs, 8, dk,
                          min(3, -(-cpr * at.KC // dk)), nout)
        - at.dec_smem_bytes(False, resolve(mode).n_limbs, 8, dk,
                            min(3, -(-cpr * at.KC // dk)), 1)
        + (nout - 1) * cpr * resolve(mode).n_orders * 1024)


@pytest.mark.parametrize("slabs,K,want", [
    (48, 768, (6, 128)),      # wq / wk / wv / wo under envelope (3, 2)
    (192, 768, (3, 64)),      # w_gate / w_up
    (48, 3072, (8, 64)),      # w_down
    (2000, 768, (1, 0)),      # lm_head: the slabs fill the card
])
def test_split_plan_on_the_envelopes_planes(slabs, K, want):
    """The mixed tick's shapes: the envelope (3, 2) of M8 / M16 / M23 /
    M16FULL rows reads three stored planes (M23's instantiation), its
    chunk sums three orders a chunk."""
    env = "M23"
    assert at.split_plan(slabs, K, env, pl=True) == want


@pytest.mark.parametrize("regs,per_sm", [(40, 5), (64, 5), (65, 4), (72, 4),
                                         (96, 3), (128, 2), (255, 1)])
def test_the_plan_takes_the_kernels_registers(regs, per_sm):
    """Blocks an SM holds by registers: at least 64 a thread, allocated in
    steps of 8; more registers than 64 lower the plan's S (QKV: at 3
    blocks an SM, S = 2 would need 128-k stages, three a rank, as many as
    one block's 256-k ones: no split)."""
    assert at.split_per_sm(False, regs) == per_sm
    assert at.split_per_sm(True, regs) == 65536 // (128 * max(
        64, -(-regs // 8) * 8))
    assert at.split_plan(144, 768, "M8", regs=regs) == (
        (4, 192) if per_sm == 5 else (3, 256) if per_sm == 4 else (1, 0))


@pytest.mark.parametrize("K,blocks,mode,nout,pl,want", [
    (768, 144, "M8", 1, False, 256),   # QKV, one weight a block: 2 an SM
    (768, 192, "M8", 2, False, 128),   # SwiGLU: two weights' rings
    (768, 144, "M23", 1, False, 128),
    (768, 48, "M23", 1, False, 256),   # fewer blocks than SMs
    (192, 10, "M8", 1, False, 192),    # K under the ring: one stage
    (768, 192, "M23", 1, True, 128),   # the mixed tick's w_gate planes
])
def test_the_single_blocks_stage(K, blocks, mode, nout, pl, want):
    """``dec_stage_k``: the ring's most, halved until two blocks share an
    SM where the grid has more blocks than the card's SMs (the plan's
    yardstick: a split on f32 weights runs fewer stages a rank)."""
    assert at.dec_stage_k(mode, 8, K, nout, blocks, pl) == want


def test_split_shared_memory_on_stored_planes():
    # w_down at S = 8: a rank's 384 k at 256 a stage, two slots of one
    # stored bf16 plane, the TMA ring's 1088 bytes, 6 chunk sums
    base = at.dec_smem_bytes(True, 1, 8, 256, 2, 1) + at.DEC_TMA_SLACK
    assert base == 2 * 256 * 16 * 2 + 2 * 8 * 256 * 4 + 2 * 8 * 264 * 2 \
        + 16 + 1088
    assert at.split_smem("M8", 8, 384, 256, 6, pl=True) == \
        -(-base // 16) * 16 + 6 * 1024


def test_the_projection_tile_pins():
    """The projection's gated block holds both weights: its tile's columns
    are those of twice the orders (64 at M8), and its f32 stages and plane
    buffers hold two weights' tiles; QKV's block holds its three weights
    at M8 (48 columns) and M16 (24), where they fit."""
    assert [at.tma_tile_n(m, 2) for m in ("M8", "M16", "M23", "M36",
                                          "M52")] == [64, 32, 24, 8, 8]
    assert at.tma_smem("M8", 2) == 1024 + 2 * (128 * 64 * 2 + 2 * 64 * 64 * 2) \
        + 2 * (128 + 2 * 64) * 64 * 4 + 32
    for mode in ("M8", "M16", "M23", "M36", "M52"):
        assert at.tma_smem(mode, 2) <= at.SMEM_MAX
        assert at.tma_smem(mode, 1) == at.tma_smem(mode)
    assert [at.tma_tile_n(m, 3) for m in ("M8", "M16", "M23")] == [48, 24, 8]
    # three K-major B planes of 48 columns and two buffers at M8
    assert at.tma_smem("M8", 3) == 1024 + 2 * (128 * 64 * 2 + 3 * 48 * 64 * 2) \
        + 2 * (128 + 3 * 48) * 64 * 4 + 32 <= at.SMEM_MAX
    assert at.tma_smem("M16", 3) <= at.SMEM_MAX


# ---------------------------------------------------------------------------
# the both-prelimbed matmul: its route by layout and format, its TMA tile's
# pins (csrc/mp_matmul_hopper.cu both_tma_kernel)
# ---------------------------------------------------------------------------
def _stacks(n, M, K, N, shift=0):
    """(n, M, K) and (n, K, N) bf16 stacks; ``shift`` elements cut off the
    front of A's rows (a base off 16 bytes)."""
    al = torch.zeros((n, M, K + shift), dtype=torch.bfloat16)[:, :, shift:]
    return al, torch.zeros((n, K, N), dtype=torch.bfloat16)


@pytest.mark.parametrize("case,mode,want", [
    ("aligned", "M8", mm.TMA), ("aligned", "M16", mm.TMA),
    ("aligned", "M23", mm.TMA), ("aligned", "M36", mm.TMA),
    ("aligned", "M52", mm.TMA),
    ("K 333 (rows of 666 bytes)", "M52", mm.MMA),
    ("base off 16 bytes", "M52", mm.MMA),
    ("N 77 (B's rows of 154 bytes)", "M36", mm.MMA),
    ("run-time format", "X28BP", mm.MMA),
])
def test_both_routes_by_layout_and_format(fake_libs, case, mode, want):
    """The TMA tile for a built-in format whose used planes a tensor map
    reads, else the mma.sync tile; chosen before the launch, the format in
    the launch's arguments."""
    from repro_torch.core.formats import register_format, unregister_format

    register_format("X28BP", mantissa_bits=28, n_limbs=4, max_order=3)
    try:
        fmt = resolve(mode)
        K = 333 if case.startswith("K 333") else 200
        N = 77 if case.startswith("N 77") else 72
        al, bl = _stacks(fmt.n_limbs, 70, K, N,
                         shift=1 if case.startswith("base") else 0)
        assert mm.both_route(al, bl, fmt) == want
        out, route = mm.launch_both_routed(0, al, bl, fmt)
        assert route == want and out.shape == (70, N)
        ((name, args),) = [c for lib in fake_libs.values() for c in lib.calls]
        assert name == ("mp_hopper_both_prelimbed_launch" if want == mm.TMA
                        else "mp_both_prelimbed_matmul_launch")
        assert args[-3:-1] == (fmt.n_limbs, fmt.max_order)
    finally:
        unregister_format("X28BP")


def test_both_route_reads_only_the_used_planes(fake_libs):
    """A stack whose plane stride is off 16 bytes still takes the TMA tile
    where the format reads one plane of it (M8), not where it reads
    more."""
    al = torch.zeros((3, 70 * 200 + 4), dtype=torch.bfloat16)
    al = al[:, :70 * 200].view(3, 70, 200)
    assert al.stride(0) % 8 != 0
    bl = torch.zeros((3, 200, 72), dtype=torch.bfloat16)
    assert mm.both_route(al, bl, "M8") == mm.TMA
    assert mm.both_route(al, bl, "M16") == mm.MMA


def test_the_both_wrapper_counts_its_routes(fake_libs, monkeypatch):
    """On CUDA tensors the wrapper launches by the route and counts it
    (the fake libraries stand in for the card)."""
    monkeypatch.setattr(mm, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(mm, "_cuda_stream", lambda *t: 0)
    kernels.reset_launch_counts()
    for K in (200, 333, 200):
        mm.mp_both_prelimbed_matmul(*_stacks(7, 70, K, 72), "M52")
    assert kernels.route_counts()["mp_both_prelimbed_matmul"] == {
        mm.TMA: 2, mm.MMA: 1}
    assert kernels.launch_counts()["mp_both_prelimbed_matmul"] == 3
    kernels.reset_launch_counts()
    assert kernels.route_counts()["mp_both_prelimbed_matmul"] == {
        mm.TMA: 0, mm.MMA: 0}


@pytest.mark.parametrize("K,want", [(200, mm.TMA), (333, mm.MMA)])
def test_the_both_launch_passes_its_argtypes(fake_libs, K, want):
    """Each route's C entry gets as many arguments as its argtypes name."""
    al, bl = _stacks(7, 70, K, 72)
    _, route = mm.launch_both_routed(0, al, bl, resolve("M52"))
    ((name, args),) = [c for lib in fake_libs.values() for c in lib.calls]
    lib = fake_libs["mp_matmul_hopper" if route == mm.TMA else "mp_matmul"]
    assert route == want and len(args) == len(getattr(lib, name).argtypes)


@pytest.mark.parametrize("mode,bm,bn,stages,smem,orders", [
    ("M8", 128, 128, 4, 1024 + 4 * (16384 + 16384) + 64, [[0], [0]]),
    ("M16", 128, 64, 4, 1024 + 4 * 2 * (16384 + 8192) + 64,
     [[0, 1], [0, 1]]),
    ("M23", 128, 64, 3, 1024 + 3 * 3 * (16384 + 8192) + 64,
     [[0, 1, 2], [0, 1, 2]]),
    ("M36", 64, 64, 2, 1024 + 2 * 5 * (8192 + 8192) + 64,
     [[0, 1, 4], [2, 3]]),
    ("M52", 64, 48, 2, 1024 + 2 * 7 * (8192 + 8192) + 64,
     [[0, 1, 2, 6], [3, 4, 5]]),
])
def test_both_tile_pins(mode, bm, bn, stages, smem, orders):
    """The both-prelimbed TMA tile's mirror: rows, columns, ring stages
    (as many as fit, at most four), shared memory; under the order split
    each warpgroup's orders, balanced by products (M52 13 / 15, M36 8 /
    7), and each thread's accumulators, the order's sum and a chain
    within the 168 registers a thread of 384 has."""
    got = at.both_tile(mode)
    assert got == dict(bm=bm, bn=bn, stages=stages, smem=smem, orders=orders)
    assert smem <= at.SMEM_MAX
    fmt = resolve(mode)
    per_order = [sum(1 for i, j in fmt.products if i + j == o)
                 for o in range(fmt.n_orders)]
    counts = [sum(per_order[o] for o in w) for w in orders]
    if bm == 64:
        assert sorted(sum(orders, [])) == list(range(fmt.n_orders))
        assert abs(counts[0] - counts[1]) <= 2
    chain = 1 if max(per_order) > 1 else 0
    regs = (max(len(w) for w in orders) + 1 + chain) * bn // 2
    assert regs <= 160


@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M36", "M52"])
def test_each_format_has_one_both_tile(mode):
    """One tile a format: the orders split over two warpgroups on 64 rows
    where five or seven orders fill them (M36, M52), else each warpgroup
    64 of 128 rows and every order."""
    fmt = resolve(mode)
    got = at.both_tile(mode)
    if fmt.n_orders in (5, 7):
        assert got["bm"] == 64
        assert not set(got["orders"][0]) & set(got["orders"][1])
    else:
        assert got["bm"] == 128
        assert got["orders"] == [list(range(fmt.n_orders))] * 2


def test_both_tile_keeps_the_generic_format_off():
    from repro_torch.core.formats import register_format, unregister_format

    register_format("X20BP", mantissa_bits=20, n_limbs=2, max_order=2)
    try:
        assert at.both_tile("X20BP") is None
    finally:
        unregister_format("X20BP")
