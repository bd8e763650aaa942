"""AdamW with dtype-configurable moments (port of ``repro.optim.adamw``).

The moments may be kept in bf16 (``moment_dtype``); every update runs in
f32, with the global-norm clip and the bias corrections in the JAX
package's f32 arithmetic, in the same order of operations.  Parameters are
the port's trees (nested dicts and lists of tensors, ``repro_torch.tree``);
an update makes new tensors and leaves the old ones as they were.

Under an FSDP layout (``dist.fsdp.Layout``) the parameters, gradients and
moments are this rank's blocks: the elementwise update runs on them
unchanged, and the clipping norm is the whole gradient's (the sharded
leaves' squares summed over the batch group, the replicated leaves' added
once), the same on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.dist import collectives, fsdp


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the parameters' device
    m: Any               # tree like params
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"    # "bfloat16" for the very large configs


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    dt = getattr(torch, cfg.moment_dtype, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown moment dtype {cfg.moment_dtype!r}")
    return dt


def init(params, cfg: AdamWConfig) -> AdamWState:
    dt = _moment_dtype(cfg)
    device = tree_lib.leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_lib.map_(zeros, params),
                      v=tree_lib.map_(zeros, params))


def _sum_sq(xs):
    total = None
    for x in xs:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return total


def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, the leaves' sums added in
    flattening order (f32).  Under ``layout`` (``tree`` this rank's blocks)
    the sharded leaves' sum is all-reduced over the batch group, then the
    replicated leaves' sum is added."""
    if layout is None:
        return torch.sqrt(_sum_sq(tree_lib.leaves(tree)))
    pairs = list(zip(tree_lib.leaves(tree), tree_lib.leaves(layout.params)))
    local = _sum_sq([x for x, s in pairs if fsdp.is_sharded(s)])
    if local is None:
        local = torch.zeros((), device=pairs[0][0].device)
    total = collectives.all_reduce(local, layout.group)
    rep = _sum_sq([x for x, s in pairs if not fsdp.is_sharded(s)])
    return torch.sqrt(total if rep is None else total + rep)


@torch.no_grad()
def apply(params, grads, state: AdamWState, cfg: AdamWConfig,
          lr_scale=1.0, layout=None) -> Tuple[Any, AdamWState, dict]:
    """One AdamW update.  Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads, layout)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step = state.step + 1
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)

    def upd(p, g, m, v):
        g = g.float() * clip
        m32, v32 = m.float(), v.float()
        m_new = cfg.b1 * m32 + (1 - cfg.b1) * g
        v_new = cfg.b2 * v32 + (1 - cfg.b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * \
            p.float()
        p_new = p.float() - lr * delta
        return (p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype))

    out = tree_lib.map_(upd, params, grads, state.m, state.v)

    def pick(i):
        return tree_lib.map_(lambda _, o: o[i], params, out)

    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), AdamWState(step, pick(1), pick(2)), metrics
