"""Input stand-ins for every (arch x shape x phase) cell on ``meta`` tensors
(port of ``repro.launch.specs``, whose ``ShapeDtypeStruct`` trees carry
shardings): shapes and dtypes at each cell's full config, no device memory.

``build_cell`` returns what the dry run (``launch/dryrun.py``) needs to run
one cell: the port's own step (``train.trainer.make_train_step``,
``make_prefill_step``, ``make_serve_step``), its meta arguments by group
(params, optimizer state, cache, batch) and the cell's layout rules.

Layout.  :func:`make_rules` decides the JAX package's layout (batch axes,
sequence axes, tensor parallelism) from the mesh's axis names and sizes
alone, so it takes a ``torch.distributed`` DeviceMesh or any stand-in with
``axis_names`` and a ``shape`` dict.  The structures here are what the
port holds per rank:

* a train cell whose rules are pure FSDP (batch axes only: no sequence
  axes, no TP) of a family without MoE layers runs the port's FSDP step
  (:func:`fsdp_layout`, ``dist/fsdp.py``): parameters and AdamW moments
  take this rank's block shapes (``param_shardings``), the batch this
  rank's rows, and the step runs on the ``cuda`` backend (each matmul on
  the rank's rows; nothing K-sharded on top of the layout);
* a decode cell of a family without MoE layers whose rules are not TP
  runs the port's decode layout (:func:`decode_layout`,
  ``dist/decode_layout.py``): the cache takes this rank's rows and its
  block of the cache sequence (over :func:`_cache_seq_axes`), the tokens
  this rank's rows, the parameters this rank's blocks under pure FSDP
  rules (whole at batch 1, where the rules have no batch axes), and the
  step runs on the ``cuda`` backend, attention sequence-parallel over the
  rank's block;
* a train or prefill cell of a family without MoE layers whose rules
  shard the sequence without TP (JAX's small-batch layout: batch over
  (``pod``,) ``data``, the sequence over ``model``) runs the port's
  Ulysses layout (:func:`seq_layout`, ``dist/seq_layout.py``): parameters
  and AdamW moments take this rank's FSDP block shapes over the batch
  axes, the batch this rank's rows with the whole sequence, a prefill's
  cache the decode layout's blocks (rows over the batch axes, the cache
  sequence over ``model``), and the step runs on the ``cuda`` backend, on
  the rank's block of the sequence;
* every other cell (the TP layouts, the MoE) keeps parameters, optimizer
  state, batch and cache whole on every rank and shards the contraction
  of each 2-D matmul over the mesh's
  ``data`` axis (the ``sharded`` backend; ROADMAP.md Queue 1 item 2): its
  structures have the global shapes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.core import context as context_lib
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import decode_layout as decode_lib
from repro_torch.dist import fsdp as fsdp_lib
from repro_torch.dist import seq_layout as seq_lib
from repro_torch.dist import sharding as sh_lib
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib

META = torch.device("meta")


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a stand-in with
    ``axis_names`` and a ``shape`` dict (the JAX mesh's attributes)."""
    if hasattr(mesh, "mesh_dim_names"):
        from repro_torch.launch import mesh as mesh_lib

        return mesh_lib.mesh_axes(mesh)
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _divisible_batch_axes(mesh, B: int,
                          include_model: bool = False) -> Tuple[str, ...]:
    """Largest prefix of the data-parallel axis group that divides B.
    include_model: allow absorbing the model axis into batch (FSDP-only
    layout — pure 2D/3D data parallelism)."""
    sizes = _axis_sizes(mesh)
    cand = [a for a in ("pod", "data") if a in sizes]
    if include_model:
        cand.append("model")
    axes = []
    prod = 1
    for a in cand:
        if B % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes) if axes else ()


def needs_tp(cfg: ModelConfig) -> bool:
    """Layout decision: tensor parallelism above 60e9 parameters, as the
    JAX package decides it.  ``REPRO_FORCE_LAYOUT=fsdp|tp`` overrides."""
    force = os.environ.get("REPRO_FORCE_LAYOUT", "")
    if force == "fsdp":
        return False
    if force == "tp":
        return True
    return cfg.param_count() > 60e9


def make_rules(mesh, cell: ShapeCell, cfg: ModelConfig) -> sh_lib.AxisRules:
    """Per-(arch x cell) layout, the JAX package's decisions:
      TP archs:                     batch (pod, data) + TP + sequence
                                    parallelism over model (train/prefill).
      FSDP archs, batch divisible:  data parallelism over (pod, data, model).
      FSDP archs, small batch:      batch (pod, data) + seq over model.
    """
    B = cell.global_batch
    tp = needs_tp(cfg)
    seq_axes: Tuple[str, ...] = ()
    if tp:
        batch_axes = _divisible_batch_axes(mesh, B)
        if cell.phase in ("train", "prefill"):
            seq_axes = ("model",)
    else:
        batch_axes = _divisible_batch_axes(
            mesh, B, include_model=cell.phase in ("train", "prefill"))
        if (cell.phase in ("train", "prefill")
                and "model" not in batch_axes):
            seq_axes = ("model",)
    return sh_lib.AxisRules(mesh=mesh, batch_axes=batch_axes or (None,),
                            model_axis="model", seq_axes=seq_axes,
                            tp_enabled=tp)


def _cache_seq_axes(mesh, cell: ShapeCell, rules=None):
    """Cache sequence sharding (JAX's ``_cache_seq_axes``): the model axis
    normally; batch 1 long-context re-purposes every idle axis for
    context parallelism."""
    if cell.global_batch == 1:
        names = _axis_sizes(mesh)
        return tuple(a for a in ("pod", "data", "model") if a in names)
    return "model"


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    phase: str
    fn: Callable
    args: tuple
    donate: tuple = ()
    # the meta arguments by group: params, opt, cache, batch
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    rules: Optional[sh_lib.AxisRules] = None
    # the FSDP, decode or Ulysses layout the step runs on (None: the
    # whole-rank run)
    layout: Optional[Union[fsdp_lib.Layout, decode_lib.DecodeLayout,
                           seq_lib.SeqLayout]] = None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def fsdp_layout(cfg: ModelConfig, cell: ShapeCell, rules
                ) -> Optional[fsdp_lib.Layout]:
    """The FSDP layout a cell's step runs on, or None for the whole-rank
    run: a train cell under pure FSDP rules whose batch axes span more than
    one rank (on one, nothing is sharded), of a family without MoE layers
    (whose router statistics would need a global reduction).  The one
    place the port decides it: the dry run, the launcher and
    ``Trainer(layout=...)``'s callers take it from here."""
    if not (cell.phase == "train" and fsdp_lib.is_pure_fsdp(rules)
            and rules.axis_size(rules.batch) > 1 and cfg.family != "moe"):
        return None
    return fsdp_lib.make_layout(T.init_params(cfg, device=META), rules)


def decode_layout(cfg: ModelConfig, cell: ShapeCell, rules
                  ) -> Optional[decode_lib.DecodeLayout]:
    """The decode layout a cell's serve step runs on, or None for the
    whole-rank run: a decode cell under rules without TP, of a family
    without MoE layers (whose experts' layout is ROADMAP.md Queue 1 item
    2d).  The cache sequence goes over :func:`_cache_seq_axes`; the
    parameters are FSDP blocks where the rules have batch axes, else
    whole.  The one place the port decides it: the dry run and the serve
    step's callers take it from here."""
    if not (rules is not None and cell.phase == "decode"
            and not rules.tp_enabled and cfg.family != "moe"
            and not cfg.encoder_only):
        return None
    return decode_lib.make_layout(
        T.init_params(cfg, device=META),
        T.make_cache(cfg, cell.global_batch, cell.seq_len, device=META),
        rules, _cache_seq_axes(rules.mesh, cell, rules))


def seq_layout(cfg: ModelConfig, cell: ShapeCell, rules
               ) -> Optional[seq_lib.SeqLayout]:
    """The Ulysses layout a cell's train or prefill step runs on, or None
    for the whole-rank run: a train or prefill cell under rules with
    sequence axes and no TP, whose batch has axes (at batch 1 on a mesh
    whose batch axes are idle the rows would repeat over them and a
    prefill's cache would split its sequence over them too,
    ``_cache_seq_axes``), of a family without MoE layers (their experts'
    layout is ROADMAP.md Queue 1 item 2d), whose sequence divides the
    sequence axes.  A prefill's cache is laid out as the decode layout's
    (rows over the batch axes, the cache sequence over
    :func:`_cache_seq_axes`).  The one place the port decides it: the dry
    run, the launcher and the steps' callers take it from here."""
    if not (rules is not None and cell.phase in ("train", "prefill")
            and rules.seq_axes and not rules.tp_enabled
            and rules.batch is not None and cfg.family != "moe"
            and cell.seq_len % rules.axis_size(rules.seq) == 0):
        return None
    cache = None
    if cell.phase == "prefill" and not cfg.encoder_only:
        cache = T.make_cache(cfg, cell.global_batch, cell.seq_len,
                             device=META)
    return seq_lib.make_layout(T.init_params(cfg, device=META), rules,
                               cell.seq_len, cache,
                               _cache_seq_axes(rules.mesh, cell, rules))


def train_layout(cfg: ModelConfig, cell: ShapeCell, rules):
    """The layout a train cell's step runs on: FSDP (:func:`fsdp_layout`)
    or Ulysses (:func:`seq_layout`), or None for the whole-rank run."""
    return fsdp_layout(cfg, cell, rules) or seq_layout(cfg, cell, rules)


def _rows(cell: ShapeCell, layout) -> int:
    return cell.global_batch // layout.size if layout is not None \
        else cell.global_batch


def batch_structs(cfg: ModelConfig, cell: ShapeCell, rules=None,
                  layout=None) -> Dict[str, torch.Tensor]:
    """The step's inputs at the global batch, or this rank's rows of it
    under ``layout`` (int32 tokens, f32 stub embeddings, as the pipelines
    make them)."""
    B, S = _rows(cell, layout), cell.seq_len
    if cfg.family == "audio":
        return {"embeds": _meta((B, S, cfg.d_model), torch.float32)}
    if cfg.family == "vlm":
        return {"tokens": _meta((B, S - cfg.n_patches), torch.int32),
                "patch_embeds": _meta((B, cfg.n_patches, cfg.d_model),
                                      torch.float32)}
    return {"tokens": _meta((B, S), torch.int32)}


def label_struct(cfg: ModelConfig, cell: ShapeCell, rules=None,
                 layout=None) -> torch.Tensor:
    B, S = _rows(cell, layout), cell.seq_len
    S_lab = S - cfg.n_patches if cfg.family == "vlm" else S
    return _meta((B, S_lab), torch.int32)


def params_structs(cfg: ModelConfig, rules=None, layout=None) -> dict:
    """The parameters' global shapes, or this rank's blocks' under
    ``layout`` (an FSDP or Ulysses layout, or a decode layout's
    parameters)."""
    params = T.init_params(cfg, device=META)
    if isinstance(layout, decode_lib.DecodeLayout):
        layout = layout.fsdp
    if layout is not None:
        params = fsdp_lib.local_structs(params, layout.params)
    return params


def state_structs(cfg: ModelConfig, rules, moment_dtype: str, layout=None):
    params = params_structs(cfg, rules, layout)
    ocfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
    return trainer_lib.TrainState(params, adamw.init(params, ocfg)), ocfg


def cache_structs(cfg: ModelConfig, cell: ShapeCell, rules=None,
                  dtype=torch.bfloat16, layout=None) -> T.ModelCache:
    """The decode cache at the cell's global shapes, or this rank's blocks'
    under a decode or Ulysses ``layout``."""
    cache = T.make_cache(cfg, cell.global_batch, cell.seq_len, dtype=dtype,
                         device=META)
    if layout is not None:
        cache = decode_lib.local_structs(cache, layout)
    return cache


def _scoped(step: Callable, rules, mesh, layout=None) -> Callable:
    """Run ``step`` under the cell's rules and, across ranks, the
    ``sharded`` backend on ``mesh`` (the port's whole-rank multi-rank
    code) or, under an FSDP, decode or Ulysses ``layout``, the ``cuda``
    backend (the step gathers; each matmul runs on the rank's rows, and
    block of the sequence or of the cache); on one process under the
    context's backend."""
    def fn(*args):
        if layout is not None:
            ctx = context_lib.context(backend="cuda")
        elif mesh is not None:
            ctx = context_lib.context(backend="sharded", mesh=mesh)
        else:
            ctx = context_lib.context()
        with sh_lib.use_rules(rules), ctx:
            return step(*args)

    return fn


def build_cell(arch: str, cfg: ModelConfig, shape: Union[str, ShapeCell],
               mesh=None, policy: Optional[PrecisionPolicy] = None) -> Cell:
    """One cell's step and meta arguments.  ``shape`` is a name of
    :data:`SHAPES` or a :class:`ShapeCell`; ``mesh`` None runs on one
    process (no rules)."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    rules = make_rules(mesh, cell, cfg) if mesh is not None else None
    policy = policy or PrecisionPolicy.train_default()

    if cell.phase == "train":
        layout = train_layout(cfg, cell, rules)
        moment_dtype = "bfloat16" if cfg.param_count() > 5e10 else "float32"
        state, ocfg = state_structs(cfg, rules, moment_dtype, layout)
        tcfg = trainer_lib.TrainerConfig(opt=ocfg)
        step = trainer_lib.make_train_step(
            cfg, policy, tcfg, mesh=mesh if layout is None else None,
            layout=layout)
        batch = batch_structs(cfg, cell, rules, layout)
        batch["labels"] = label_struct(cfg, cell, rules, layout)
        return Cell(arch, cell.name, "train",
                    _scoped(step, rules, mesh, layout), (state, batch),
                    donate=(0,),
                    groups={"params": state.params, "opt": state.opt,
                            "batch": batch}, rules=rules, layout=layout)

    if cell.phase == "prefill":
        layout = seq_layout(cfg, cell, rules)
        params = params_structs(cfg, rules, layout)
        inputs = batch_structs(cfg, cell, rules, layout)
        pre = trainer_lib.make_prefill_step(
            cfg, policy, mesh=mesh if layout is None else None,
            layout=layout)
        if cfg.encoder_only:
            def enc(params, inputs):
                return pre(params, inputs, None)[0]

            return Cell(arch, cell.name, "prefill",
                        _scoped(enc, rules, mesh, layout), (params, inputs),
                        groups={"params": params, "batch": inputs},
                        rules=rules, layout=layout)
        cache = cache_structs(cfg, cell, rules, layout=layout)
        return Cell(arch, cell.name, "prefill",
                    _scoped(pre, rules, mesh, layout),
                    (params, inputs, cache), donate=(2,),
                    groups={"params": params, "cache": cache,
                            "batch": inputs}, rules=rules, layout=layout)

    # decode: one new token per sequence against a full-length cache (on
    # its layout: this rank's rows and blocks)
    layout = decode_layout(cfg, cell, rules)
    params = params_structs(cfg, rules, layout)
    cache = cache_structs(cfg, cell, rules, layout=layout)
    tok = _meta((_rows(cell, layout), 1), torch.int32)
    srv = trainer_lib.make_serve_step(
        cfg, policy, mesh=mesh if layout is None else None, layout=layout)
    return Cell(arch, cell.name, "decode", _scoped(srv, rules, mesh, layout),
                (params, cache, tok), donate=(1,),
                groups={"params": params, "cache": cache, "batch": tok},
                rules=rules, layout=layout)
