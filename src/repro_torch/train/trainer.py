"""Fault-tolerant training loop and its step (port of
``repro.train.trainer``; every model family, on one device, with the
MoE family's expert-parallel mesh, or across ranks in the FSDP layout).

    train_step(state, batch) -> (state', metrics)

The step is the forward of ``models.transformer`` under the precision
policy, the f32 cross entropy plus the MoE aux and router z-losses, the
backward through the differentiable
multi-precision ops (``core/mpmatmul.py``: the forward kernels at the
dgrad/wgrad formats) and one AdamW update.  PyTorch runs it eagerly: there
is no ``jit``, and a step is one call.

Fault tolerance (held against the JAX package's tests):
  * checkpoint every N steps (atomic, retained);
  * NaN/Inf blow-up detection -> rollback to the last checkpoint and
    escalation to ``full_fp32`` (the paper's reconfigurability doubling as a
    resilience lever);
  * restart: ``run()`` resumes from the latest checkpoint, the deterministic
    data pipeline replays from the stored step;
  * straggler hook: steps slower than ``straggler_factor`` x the rolling
    median are counted.

The FSDP layout (``dist/fsdp.py``; ``launch/specs.fsdp_layout`` decides
it from ``make_rules``): ``Trainer(layout=...)`` holds this rank's block of
every parameter and moment (``param_shardings``) and feeds the step its
rows of each global batch;
the step returns the global loss and metrics (reduced over the batch
group, so every rank rolls back together) and the blocks' new values, and
checkpoints hold the global arrays (gathered, written by rank 0).  The
Ulysses layout (``dist/seq_layout.py``; ``launch/specs.seq_layout``) is
the same on the state, and feeds the step each row's whole sequence, of
which it runs the rank's block; the metrics reduce over every rank.

The trainer runs on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper runs its plain version; without a card
it raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import context as context_lib
from repro_torch.core.classify import all_finite
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import fsdp as fsdp_lib
from repro_torch.dist import seq_layout as seq_lib
from repro_torch.dist import sharding as sh_lib
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim import schedule as sched_lib
# the serving steps live with the engine; the JAX package keeps them here
from repro_torch.serve.engine import (  # noqa: F401
    make_prefill_step, make_serve_step)
from repro_torch.train.metrics import MetricsLogger


# a step's layout: FSDP (dist/fsdp.py) or Ulysses (dist/seq_layout.py)
Layout = Union[fsdp_lib.Layout, seq_lib.SeqLayout]


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


@dataclasses.dataclass
class TrainerConfig:
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    schedule: str = "warmup_cosine"
    warmup: int = 100
    total_steps: int = 1000
    microbatch: int = 0          # 0 = no gradient accumulation
    aux_weight: float = 0.01
    zloss_weight: float = 1e-4
    ckpt_dir: str = ""
    ckpt_every: int = 100
    keep: int = 3
    straggler_factor: float = 3.0
    escalate_on_nan: bool = True
    metrics_path: str = ""       # JSONL observability sink (train/metrics.py)
    # mp_matmul dispatch backend for the steps ("" = the context's;
    # "cuda" / "ref" / "sharded" — core/dispatch.py)
    matmul_backend: str = ""


def make_loss_fn(cfg: ModelConfig, policy: PrecisionPolicy,
                 tcfg: Optional[TrainerConfig] = None,
                 mesh=None, layout: Optional[Layout] = None) -> Callable:
    """loss_fn(params, batch) -> (loss, extras): the mean over tokens of the
    f32 ``logsumexp`` minus the label's logit (the VLM's patch positions
    sliced off), plus ``tcfg.aux_weight`` x the MoE load-balance aux and
    ``tcfg.zloss_weight`` x the router z-loss (zeros for the other
    families); extras ``{"nll", "moe_aux", "moe_zloss"}``.  ``tcfg``
    defaults to ``TrainerConfig()``'s weights.

    ``layout``: an FSDP or a Ulysses layout; ``batch`` then holds this
    rank's rows, and the loss and extras are this rank's share of the
    global mean (``dist.fsdp.local_loss``: its rows' mean over the batch
    group's size), so that the sums over the layout's ranks of the loss
    (``metrics_group``) and of the gradients are the global mean's.  Under
    a Ulysses layout (``dist/seq_layout.py``, installed around the
    forward) the rows hold the whole sequence, the logits are the rank's
    block's, the labels are cut to the block by global position (the
    VLM's patch positions carry none), and the rows' mean is the block's
    tokens' sum over the rows' token count."""
    tcfg = tcfg if tcfg is not None else TrainerConfig()
    seq = layout if isinstance(layout, seq_lib.SeqLayout) else None

    def loss_fn(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        labels = batch["labels"]
        n_prefix = (inputs["patch_embeds"].shape[1]
                    if cfg.family == "vlm" and "patch_embeds" in inputs
                    else 0)
        with seq_lib.use_seq_layout(seq) if seq is not None \
                else contextlib.nullcontext():
            logits, aux, _ = T.forward(params, inputs, cfg, policy,
                                       mesh=mesh)
        if seq is not None:
            logits, labels = seq_lib.label_block(logits, labels, n_prefix,
                                                 seq)
        elif n_prefix:
            logits = logits[:, n_prefix:, :]
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        if seq is not None:   # the block's share of its rows' mean
            nll = (lse - picked).sum() / float(batch["labels"].numel())
        else:
            nll = torch.mean(lse - picked)
        loss = (nll + tcfg.aux_weight * aux["moe_aux"]
                + tcfg.zloss_weight * aux["moe_zloss"])
        return loss, {"nll": nll, **aux}

    return loss_fn if layout is None else fsdp_lib.local_loss(loss_fn,
                                                              layout)


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, extras), grads): the loss at ``params`` and its gradient, a
    tree of ``params``' structure (``params`` themselves are not marked)."""
    live = tree_lib.map_(lambda p: p.detach().requires_grad_(True), params)
    loss, extras = loss_fn(live, batch)
    flat = tree_lib.leaves(live)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g)
             for p, g in zip(flat, got)}
    grads = tree_lib.map_(lambda p: by_id[id(p)], live)
    extras = {k: v.detach() for k, v in extras.items()}
    return (loss.detach(), extras), grads


def _backend_scope(name: str):
    return context_lib.context(backend=name) if name \
        else contextlib.nullcontext()


def make_train_step(cfg: ModelConfig, policy: PrecisionPolicy,
                    tcfg: TrainerConfig, mesh=None,
                    layout: Optional[Layout] = None) -> Callable:
    """``train_step(state, batch) -> (state', metrics)``.  Under an FSDP or
    a Ulysses ``layout`` the state holds this rank's blocks and ``batch``
    its rows (under the Ulysses layout with the whole sequence, of which
    the step runs the rank's block); the metrics are the global ones, the
    same on every rank."""
    loss_fn = make_loss_fn(cfg, policy, tcfg, mesh=mesh, layout=layout)
    sched = sched_lib.SCHEDULES[tcfg.schedule]

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        with _backend_scope(tcfg.matmul_backend):
            if tcfg.microbatch and tcfg.microbatch < _batch_size(batch):
                grads, metrics = _accum_grads(loss_fn, state.params, batch,
                                              tcfg.microbatch)
            else:
                (loss, extras), grads = value_and_grad(loss_fn, state.params,
                                                       batch)
                metrics = {"loss": loss, **extras}
        lr_scale = sched(state.opt.step, warmup=tcfg.warmup,
                         total=tcfg.total_steps)
        new_params, new_opt, opt_metrics = adamw.apply(
            state.params, grads, state.opt, tcfg.opt, lr_scale, layout)
        metrics.update(opt_metrics)
        metrics["params_finite"] = all_finite(new_params).float()
        if layout is not None:
            metrics = fsdp_lib.reduce_metrics(metrics, layout)
        return TrainState(new_params, new_opt), metrics

    return train_step


def _batch_size(batch) -> int:
    return next(iter(batch.values())).shape[0]


def _accum_grads(loss_fn, params, batch, micro: int):
    """Gradient accumulation over microbatches of ``micro`` rows, in row
    order: the mean of their gradients and of their losses (aux terms
    included); the metrics report that mean as ``nll`` and zero aux, as
    the JAX package does."""
    B = _batch_size(batch)
    if B % micro:
        raise ValueError(f"batch {B} is not a multiple of microbatch {micro}")
    n = B // micro
    g_acc = tree_lib.map_(lambda p: torch.zeros(p.shape, device=p.device),
                          params)
    l_acc = None
    for i in range(n):
        mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
        (loss, _), g = value_and_grad(loss_fn, params, mb)
        g_acc = tree_lib.map_(torch.add, g_acc, g)
        l_acc = loss if l_acc is None else l_acc + loss
    g_mean = tree_lib.map_(lambda g: g / n, g_acc)
    zero = torch.zeros((), device=l_acc.device)
    return g_mean, {"loss": l_acc / n, "nll": l_acc / n, "moe_aux": zero,
                    "moe_zloss": zero}


# =========================================================================
# the fault-tolerant loop
# =========================================================================
class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 policy: Optional[PrecisionPolicy] = None,
                 escalation_policy: Optional[PrecisionPolicy] = None,
                 device: str = "cuda", mesh=None,
                 layout: Optional[Layout] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run the plain versions "
                               "of the kernels on the CPU")
        self.cfg = cfg
        self.tcfg = tcfg
        # passed to the forward, as in the JAX package (the MoE family's
        # expert-parallel mesh; the other families ignore it)
        self.mesh = mesh
        # the FSDP layout of the state and the step (None: the whole state
        # on this rank)
        self.layout = layout
        if layout is not None and tcfg.matmul_backend == "sharded":
            raise ValueError("the FSDP layout runs each matmul on the "
                             "rank's rows; the sharded backend would "
                             "K-shard them again over the mesh")
        # explicit policy > active PrecisionContext's policy > recipe default
        self.policy = (policy or context_lib.current_context().policy
                       or PrecisionPolicy.train_default())
        self.escalation_policy = (escalation_policy
                                  or PrecisionPolicy.full_fp32())
        self._step_fn = make_train_step(cfg, self.policy, tcfg,
                                        mesh=self.mesh, layout=self.layout)
        self._escalated_fn = None
        self._step_times: list = []
        self.straggler_events = 0
        self.rollbacks = 0
        self.metrics = MetricsLogger(tcfg.metrics_path or None)

    def init_state(self, seed: int = 0) -> TrainState:
        """The state from ``seed``; under the layout, this rank's blocks of
        the whole ``init_params`` (the one-rank values)."""
        params = T.init_params(self.cfg, seed, device=self.device)
        if self.layout is not None:
            params = fsdp_lib.shard_tree(params, self.layout.params)
        return TrainState(params, adamw.init(params, self.tcfg.opt))

    def state_shardings(self) -> Optional[TrainState]:
        """The layout's :class:`~repro_torch.dist.sharding.Sharding` of
        every leaf of the state (the moments the parameters'; the step
        replicated), or None without a layout."""
        if self.layout is None:
            return None
        p = self.layout.params
        step = sh_lib.Sharding(self.layout.rules.mesh, ())
        return TrainState(p, adamw.AdamWState(step, p, p))

    def to_device(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """A pipeline's numpy batch on the trainer's device; under the
        layout, this rank's rows of it."""
        if self.layout is not None:
            rows = sh_lib.batch_rows(self.layout.rules,
                                     len(next(iter(batch.values()))))
            batch = {k: v[rows] for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def maybe_restore(self, state: TrainState) -> Tuple[TrainState, int]:
        if not self.tcfg.ckpt_dir:
            return state, 0
        step = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return state, 0
        restored, extra = ckpt_lib.restore(
            self.tcfg.ckpt_dir, step, state,
            shardings=self.state_shardings(), local=True)
        return restored, int(extra.get("data_step", step))

    def run(self, pipeline, *, start_step: int = 0, num_steps: int = 100,
            log_every: int = 10, state: Optional[TrainState] = None):
        state = state if state is not None else self.init_state()
        state, resume_step = self.maybe_restore(state)
        step = max(start_step, resume_step)
        last_good = step
        history = []
        fn = self._step_fn
        while step < num_steps:
            batch = self.to_device(pipeline.batch(step))
            t0 = time.perf_counter()
            state, metrics = fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self._watch_straggler(dt)

            if not np.isfinite(loss) or float(metrics["params_finite"]) < 1:
                # blow-up: rollback + escalate precision (paper mode ladder)
                self.rollbacks += 1
                self.metrics.log_event("nan_rollback", step=step)
                state, _ = self.maybe_restore(state)
                step = last_good
                if self.tcfg.escalate_on_nan:
                    if self._escalated_fn is None:
                        self._escalated_fn = make_train_step(
                            self.cfg, self.escalation_policy, self.tcfg,
                            mesh=self.mesh, layout=self.layout)
                    fn = self._escalated_fn
                continue

            step += 1
            history.append(loss)
            self.metrics.log_step(step, {"loss": loss,
                                         "grad_norm": metrics["grad_norm"],
                                         "lr": metrics["lr"]})
            if self.tcfg.ckpt_dir and step % self.tcfg.ckpt_every == 0:
                ckpt_lib.save(self.tcfg.ckpt_dir, step, state,
                              keep=self.tcfg.keep,
                              extra_meta={"data_step": step},
                              shardings=self.state_shardings())
                last_good = step
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms")
        return state, history

    def _watch_straggler(self, dt: float):
        self._step_times.append(dt)
        window = self._step_times[-32:]
        if len(window) >= 8:
            med = float(np.median(window))
            if dt > self.tcfg.straggler_factor * med:
                self.straggler_events += 1
