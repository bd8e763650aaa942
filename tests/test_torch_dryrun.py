"""The port's meta-device dry run (``repro_torch.launch.specs``,
``repro_torch.launch.dryrun``) against the JAX package's: ``make_rules``
decides the same layout for every registry id x shape x production mesh,
the RUN / SKIP decisions are ``repro.configs.shapes.applicability``'s, the
meta structures hold the bytes of the real SMOKE state, and a handful of
full-size cells run in a subprocess (the fake process group never enters
this process, and ``repro.launch.dryrun``, which sets ``XLA_FLAGS`` at
import, is never imported)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import applicability as japplicability
from repro.launch import specs as jspecs
from repro_torch.configs.registry import ARCH_IDS, assigned_archs, get_config
from repro_torch.configs.shapes import SHAPE_ORDER, SHAPES
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import specs
from repro_torch.launch.dryrun import nbytes
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StandInMesh:
    """What ``make_rules`` reads of a mesh in either package: its axis names
    and sizes (a 256- or 512-device mesh needs no devices here)."""

    def __init__(self, multi_pod: bool):
        sizes = (2, 16, 16) if multi_pod else (16, 16)
        self.axis_names = (("pod", "data", "model") if multi_pod
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names, sizes))


@pytest.mark.parametrize("force", ["", "fsdp", "tp"])
def test_make_rules_is_jax(force, monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_LAYOUT", force)
    n = 0
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert specs.needs_tp(cfg) == jspecs.needs_tp(jcfg), arch
        for shape in SHAPE_ORDER:
            for multi in (False, True):
                mesh = StandInMesh(multi)
                got = specs.make_rules(mesh, SHAPES[shape], cfg)
                want = jspecs.make_rules(mesh, JSHAPES[shape], jcfg)
                assert (got.batch_axes, got.seq_axes, got.tp_enabled,
                        got.model_axis) == \
                    (want.batch_axes, want.seq_axes, want.tp_enabled,
                     want.model_axis), (arch, shape, multi)
                n += 1
    assert n == 11 * 4 * 2


def test_run_skip_decisions_are_jax():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--list",
         "--all"], capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 10 * 4
    for line in lines:
        arch, shape, verdict = line.split(None, 2)
        ok, reason = japplicability(jget_config(arch), shape)
        assert verdict == ("RUN" if ok else "SKIP: " + reason), line


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_params_are_the_real_shapes(arch):
    cfg = get_config(arch, smoke=True)
    real = T.init_params(cfg, seed=0)
    meta = specs.params_structs(cfg)
    flat_r, flat_m = _leaves(real), _leaves(meta)
    assert [(t.shape, t.dtype) for t in flat_m] == \
        [(t.shape, t.dtype) for t in flat_r]
    assert all(t.is_meta for t in flat_m)
    assert nbytes(meta) == nbytes(real)


@pytest.mark.parametrize("arch", ["paper-mpfp-100m", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b", "llava-next-34b",
                                  "hubert-xlarge"])
def test_meta_argument_bytes_are_the_real_smoke_state(arch):
    """The train state (AdamW f32 moments), the batch the pipeline makes and
    the decode cache: meta bytes == the real tensors' nbytes."""
    cfg = get_config(arch, smoke=True)
    cell = specs.ShapeCell("smoke", 64, 2, "train")
    state, ocfg = specs.state_structs(cfg, None, "float32")
    params = T.init_params(cfg, seed=0)
    real_state = (params, adamw.init(params, ocfg))
    assert nbytes(state) == nbytes(real_state)
    batch = specs.batch_structs(cfg, cell)
    batch["labels"] = specs.label_struct(cfg, cell)
    # a cell's seq_len counts the VLM's patches; the pipeline's tokens not
    s_tok = 64 - (cfg.n_patches if cfg.family == "vlm" else 0)
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=s_tok + 1,
                                  global_batch=2, frontend=cfg.frontend,
                                  d_model=cfg.d_model,
                                  n_patches=cfg.n_patches))
    real_batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in pipe.batch(0).items()}
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in real_batch.items()}
    assert nbytes(batch) == nbytes(real_batch)
    if not cfg.encoder_only:
        cache = specs.cache_structs(cfg, cell)
        assert nbytes(cache) == nbytes(T.make_cache(cfg, 2, 64))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


CELLS = (("deepseek-7b", "decode_32k"),          # dense, decode layout
         ("mamba2-130m", "prefill_32k"),          # SSM, Ulysses layout
         ("deepseek-v2-lite-16b", "decode_32k"),  # MoE (MLA)
         ("mamba2-130m", "long_500k"),            # SSM, batch 1
         ("zamba2-2.7b", "long_500k"),            # hybrid, batch 1
         ("hubert-xlarge", "train_4k"),           # encoder-only, FSDP
         ("deepseek-7b", "train_4k"),             # dense, FSDP
         ("hubert-xlarge", "decode_32k"),         # skip: no decode step
         ("deepseek-7b", "long_500k"))            # skip: full attention


def _ported(want, cfg, shape) -> bool:
    """Does the port run this cell on its layout: a train cell whose JAX
    rules shard the batch alone (FSDP), a decode cell whose rules are not
    TP (the decode layout), or a train or prefill cell whose rules shard
    the batch and the sequence without TP (Ulysses), of a family without
    MoE layers."""
    phase = JSHAPES[shape].phase
    fsdp = (phase == "train" and want.batch_axes != (None,)
            and not want.seq_axes and not want.tp_enabled)
    ulysses = (phase in ("train", "prefill") and want.batch_axes != (None,)
               and bool(want.seq_axes) and not want.tp_enabled)
    return (fsdp or ulysses or (phase == "decode" and not want.tp_enabled)) \
        and cfg.family != "moe"


def _cache_block_bytes(cache, rows: int, seq: int) -> int:
    """JAX's decode arithmetic on the port's per-layer cache: each tensor's
    rows over the ``rows`` ranks of the batch axes, the sequence tensors'
    positions over the ``seq`` ranks of the sequence axes, where they
    divide."""
    total = 0
    for group in ("attn", "dense_attn", "ssm", "shared_attn"):
        for c in getattr(cache, group) or []:
            for f in ("k", "v", "c_kv", "k_rope", "conv", "state"):
                x = getattr(c, f, None)
                if x is None:
                    continue
                n = rows if x.shape[0] % rows == 0 else 1
                if f not in ("conv", "state") and x.shape[1] % seq == 0:
                    n *= seq
                total += x.numel() * x.element_size() // n
    return total


def _block_bytes(tree, n: int) -> int:
    """JAX's FSDP arithmetic: each leaf's trailing dim over the n ranks of
    the batch axes where it divides, else the whole leaf."""
    return sum(x.numel() * x.element_size() // (
        n if x.ndim and x.shape[-1] % n == 0 else 1) for x in _leaves(tree))


def test_cells_in_a_subprocess(tmp_path):
    """Full-size cells as rank 0 of the 256-rank fake world: ok records with
    the layout of ``make_rules``, per-rank work and memory, the H100
    roofline; skip records with JAX's reasons.  A train cell under pure
    FSDP rules (``layout.ported``) holds the layout's blocks and rows and
    gathers and reduce-scatters them; a decode cell without MoE layers or
    TP (``layout.ported``) its rows, its cache blocks and its parameter
    blocks over the batch axes (whole at batch 1), with three all-reduces
    an attention layer; a prefill cell under the Ulysses rules
    (``layout.ported``) its rows, its parameter and cache blocks, and the
    SSM's hand-over and broadcasts; every other cell whole parameters."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "single", "--out", str(tmp_path), "--cells",
         ",".join(f"{a}:{s}" for a, s in CELLS)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    for arch, shape in CELLS:
        with open(tmp_path / f"singlepod_{arch}_{shape}.json") as f:
            rec = json.load(f)
        ok, reason = japplicability(jget_config(arch), shape)
        if not ok:
            assert rec["status"] == "skip" and rec["reason"] == reason
            continue
        assert rec["status"] == "ok", rec["reason"]
        assert rec["n_chips"] == 256 and rec["trace_s"] > 0
        want = jspecs.make_rules(StandInMesh(False), JSHAPES[shape],
                                 jget_config(arch))
        cfg = get_config(arch)
        ported = _ported(want, cfg, shape)
        assert rec["layout"] == {
            "batch_axes": [a for a in want.batch_axes if a],
            "seq_axes": list(want.seq_axes), "tp_enabled": want.tp_enabled,
            "ported": ported}
        mem, work = rec["memory"], rec["work"]
        scell = JSHAPES[shape]
        if ported and scell.phase == "decode":
            # its rows and cache blocks; parameter blocks over the batch
            # axes (data, 16 ranks), whole at batch 1
            rows = 16 if want.batch_axes != (None,) else 1
            seq = 16 if scell.global_batch > 1 else 256
            cache = specs.cache_structs(cfg, scell)
            assert mem["cache_bytes"] == _cache_block_bytes(cache, rows, seq)
            params = specs.params_structs(cfg)
            assert mem["params_bytes"] == (_block_bytes(params, rows)
                                           if rows > 1 else nbytes(params))
            assert mem["batch_bytes"] == 4 * scell.global_batch // rows
            assert (work["collective_bytes"].get("all_gather", 0) > 0) == \
                (rows > 1)
            n_attn = {"ssm": 0, "hybrid": cfg.n_layers
                      // max(1, cfg.hybrid_attn_every)}.get(cfg.family,
                                                          cfg.n_layers)
            assert work["collective_calls"].get("all_reduce", 0) == \
                3 * n_attn
        elif ported and want.seq_axes:   # Ulysses: data's 16 ranks
            params = specs.params_structs(cfg)
            assert mem["params_bytes"] == _block_bytes(params, 16)
            cache = specs.cache_structs(cfg, scell)
            assert mem["cache_bytes"] == _cache_block_bytes(cache, 16, 16)
            batch = specs.batch_structs(cfg, scell)
            assert mem["batch_bytes"] == nbytes(batch) // 16
            # the parameter gathers; each Mamba2 layer's carry to the next
            # block; the last block's states and logits to every block
            assert work["collective_calls"]["all_gather"] > 0
            assert work["collective_calls"]["send"] == 2 * cfg.n_layers
            assert work["collective_calls"]["broadcast"] == \
                2 * cfg.n_layers + 1
        elif ported:   # this rank's blocks of params and f32 moments, rows
            params = specs.params_structs(cfg)
            assert mem["params_bytes"] == _block_bytes(params, 256)
            assert mem["opt_bytes"] == 2 * _block_bytes(params, 256) + 4
            batch = specs.batch_structs(cfg, JSHAPES[shape])
            batch["labels"] = specs.label_struct(cfg, JSHAPES[shape])
            assert mem["batch_bytes"] == nbytes(batch) // 256
            assert work["collective_bytes"]["all_gather"] > 0
            assert work["collective_bytes"]["reduce_scatter"] > 0
        else:        # the port holds the parameters whole on every rank
            assert mem["params_bytes"] == nbytes(specs.params_structs(cfg))
        assert mem["argument_bytes"] == sum(
            v for k, v in mem.items() if k.endswith("_bytes")
            and k not in ("argument_bytes", "output_bytes", "peak_bytes"))
        assert mem["peak_bytes"] is None and mem["output_bytes"] > 0
        assert work["flops"] > 0 and work["bytes"] > 0
        roof = rec["roofline"]
        assert roof["hardware"] == "NVIDIA H100 80GB HBM3"
        assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                      roof["collective_s"])
        assert roof["flops_per_chip"] == work["flops"]
        if shape == "train_4k":   # K-sharded matmuls: the all-reduces
            assert work["collective_bytes"]["all_reduce"] > 0
    assert arch in assigned_archs()
    # deepseek-7b at train_4k: every leaf's trailing dim divides 256, so a
    # rank holds 1/256 of the 27.6 GB of f32 parameters (107,974,464 bytes)
    with open(tmp_path / "singlepod_deepseek-7b_train_4k.json") as f:
        assert json.load(f)["memory"]["params_bytes"] == nbytes(
            specs.params_structs(get_config("deepseek-7b"))) // 256 \
            == 107_974_464
    # the decode layout's bytes a rank, JAX's per-device shard bytes less
    # the int32 length leaves (4 bytes a layer), which the port holds as
    # Python ints: deepseek-7b's 1,920 GiB cache over 256 ranks and its
    # parameters over data's 16; zamba2's 500k context cache over 256,
    # its parameters whole; mamba2's long_500k state whole (no sequence)
    mem = {}
    for arch, shape in (("deepseek-7b", "decode_32k"),
                        ("zamba2-2.7b", "long_500k"),
                        ("mamba2-130m", "long_500k")):
        with open(tmp_path / f"singlepod_{arch}_{shape}.json") as f:
            mem[arch] = json.load(f)["memory"]
    assert (mem["deepseek-7b"]["cache_bytes"],
            mem["deepseek-7b"]["params_bytes"]) == (8_053_063_680,
                                                    1_727_591_424)
    assert mem["zamba2-2.7b"]["cache_bytes"] == 262_923_264
    assert mem["zamba2-2.7b"]["params_bytes"] == nbytes(
        specs.params_structs(get_config("zamba2-2.7b")))
    assert mem["mamba2-130m"]["cache_bytes"] == nbytes(
        specs.cache_structs(get_config("mamba2-130m"), JSHAPES["long_500k"]))
    assert mem["mamba2-130m"]["params_bytes"] == nbytes(
        specs.params_structs(get_config("mamba2-130m")))


class CoordMesh:
    """A production mesh at one rank's coordinates: what the layouts read
    of a ``DeviceMesh`` (names, sizes, coordinates), no process group."""

    def __init__(self, multi_pod: bool, coord=None):
        sizes = (2, 16, 16) if multi_pod else (16, 16)
        self.mesh_dim_names = (("pod", "data", "model") if multi_pod
                               else ("data", "model"))
        self.shape = sizes
        self.axis_names = self.mesh_dim_names
        self._coord = list(coord or (0,) * len(sizes))

    def size(self, i):
        return self.shape[i]

    def get_coordinate(self):
        return self._coord


ULYSSES_ARCHS = ("minicpm3-4b", "deepseek-7b", "chatglm3-6b", "mamba2-130m",
                 "llava-next-34b", "zamba2-2.7b", "hubert-xlarge")


def _ulysses_cells():
    """JAX's small-batch layout without MoE or TP: prefill_32k on both
    meshes and multipod train_4k, for the seven ids."""
    return [(a, s, m) for a in ULYSSES_ARCHS
            for s, m in (("prefill_32k", False), ("prefill_32k", True),
                         ("train_4k", True))]


def test_the_ulysses_cells_are_every_non_moe_non_tp_sequence_cell():
    """The 21 cells are exactly the assigned ids' cells whose JAX rules
    shard the sequence without TP, of a family without MoE layers; each
    gets the layout."""
    got = []
    for arch in assigned_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape in ("train_4k", "prefill_32k"):
            for multi in (False, True):
                want = jspecs.make_rules(StandInMesh(multi), JSHAPES[shape],
                                         jcfg)
                if not want.seq_axes or want.tp_enabled \
                        or cfg.family == "moe":
                    continue
                got.append((arch, shape, multi))
                rules = specs.make_rules(CoordMesh(multi), SHAPES[shape],
                                         cfg)
                assert specs.seq_layout(cfg, SHAPES[shape], rules) \
                    is not None, (arch, shape, multi)
                assert _ported(want, cfg, shape)
    assert sorted(got) == sorted(_ulysses_cells())


@pytest.mark.parametrize("arch,shape,multi", _ulysses_cells())
def test_ulysses_cells_hold_jax_arithmetic(arch, shape, multi):
    """A rank's structures under the layout (``build_cell``'s: params,
    AdamW moments, batch rows with the whole sequence, prefill cache
    blocks) at rank 0's coordinates: JAX's per-device arithmetic — each
    leaf's trailing dim over the batch axes (16 or 32 ranks) where it
    divides, the batch's rows over them, the cache's rows over them and
    its sequence over model's 16 (the SSM states by rows, the stated
    exception)."""
    cfg, scell = get_config(arch), SHAPES[shape]
    rules = specs.make_rules(CoordMesh(multi), scell, cfg)
    layout = specs.seq_layout(cfg, scell, rules)
    n = 32 if multi else 16
    assert layout.size == n and layout.model_size == 16
    assert layout.block == (0, scell.seq_len // 16)
    params = specs.params_structs(cfg)
    assert nbytes(specs.params_structs(cfg, rules, layout)) == \
        _block_bytes(params, n)
    batch = specs.batch_structs(cfg, scell, rules, layout)
    whole = specs.batch_structs(cfg, scell)
    if scell.phase == "train":
        batch["labels"] = specs.label_struct(cfg, scell, rules, layout)
        whole["labels"] = specs.label_struct(cfg, scell)
        state, _ = specs.state_structs(cfg, rules, "float32", layout)
        assert nbytes(state.opt) == 2 * _block_bytes(params, n) + 4
    assert nbytes(batch) == nbytes(whole) // n
    if scell.phase == "prefill" and not cfg.encoder_only:
        assert nbytes(specs.cache_structs(cfg, scell, rules,
                                          layout=layout)) == \
            _cache_block_bytes(specs.cache_structs(cfg, scell), n, 16)


def test_the_pinned_ulysses_cells():
    """JAX's bytes a device (summed ``shard_shape`` over its structures
    on 256 fake devices) less its int32 ``length`` leaves, 4 bytes a
    layer: deepseek-7b prefill_32k single pod, where the port held
    505.75 GiB a rank whole; mamba2-130m prefill_32k's cache."""
    got = {}
    for arch in ("deepseek-7b", "mamba2-130m"):
        cfg, scell = get_config(arch), SHAPES["prefill_32k"]
        rules = specs.make_rules(CoordMesh(False), scell, cfg)
        layout = specs.seq_layout(cfg, scell, rules)
        got[arch] = (nbytes(specs.params_structs(cfg, rules, layout)),
                     nbytes(specs.cache_structs(cfg, scell, rules,
                                                layout=layout)),
                     nbytes(specs.batch_structs(cfg, scell, rules, layout)))
    assert got["deepseek-7b"] == (1_727_591_424, 2_013_265_920, 262_144)
    assert got["mamba2-130m"][1] == 38_781_024 - 4 * 24
