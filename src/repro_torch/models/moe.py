"""Mixture-of-Experts FFN (port of ``repro.models.moe``; DeepSeek-V2 style:
shared + routed experts, top-k softmax gating), the all-experts realization.

Every expert runs on every token and the gated combine keeps each token's
top-k: exact (no capacity drops).  The JAX package maps the E experts one at
a time; here each of the three expert contractions is ONE batched launch,
the (T, D) tokens broadcast against the stacked (E, D, F) weights, each
batch entry summed in the order of a lone launch (so bitwise the
per-expert loop).  The gate combine ``te,etd->td`` is a plain f32 einsum, as
XLA computes it in the JAX package.

The router runs at the policy's ``moe_router`` format (M23 by default),
the expert FFNs at ``moe_expert``.  The expert-parallel realization over a
mesh (``moe_forward_ep``) is not ported yet: a forward given a mesh raises.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.mpmatmul import mp_matmul
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models.layers import dense_init, normal, swiglu_mlp


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0
    shared_ff: int = 0           # defaults to n_shared * expert_ff

    @property
    def shared_ff_dim(self) -> int:
        return self.shared_ff or self.n_shared * self.expert_ff


def init_moe_params(gen: torch.Generator, dims: MoEDims, device=None
                    ) -> dict:
    d, e, f = dims.d_model, dims.n_experts, dims.expert_ff
    p = {
        "router": dense_init(gen, d, e, scale=0.02, device=device),
        # stacked expert weights: (E, D, F) / (E, F, D)
        "w_gate": normal(gen, (e, d, f), d ** -0.5, device),
        "w_up": normal(gen, (e, d, f), d ** -0.5, device),
        "w_down": normal(gen, (e, f, d), f ** -0.5, device),
    }
    if dims.n_shared > 0:
        sf = dims.shared_ff_dim
        p["shared"] = {
            "w_gate": dense_init(gen, d, sf, device=device),
            "w_up": dense_init(gen, d, sf, device=device),
            "w_down": dense_init(gen, sf, d, device=device),
        }
    return p


def _route(x2d: torch.Tensor, w_router: torch.Tensor, dims: MoEDims,
           policy: PrecisionPolicy):
    """Router: logits -> top-k, renormalized softmax over the chosen k;
    the Switch-style load-balance aux and the router z-loss."""
    logits = mp_matmul(x2d, w_router, policy.mode("moe_router"),
                       **policy.bwd_kwargs("moe_router"))
    probs = torch.softmax(logits.float(), dim=-1)
    # descending, ties to the lower index (jax.lax.top_k's order)
    top_p, top_i = torch.topk(probs, dims.top_k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    T = x2d.shape[0]
    me = probs.mean(dim=0)                                   # mean prob per e
    counts = torch.zeros(dims.n_experts, device=x2d.device).index_add_(
        0, top_i.reshape(-1), torch.ones(top_i.numel(), device=x2d.device)
    ) / (T * dims.top_k)
    aux = dims.n_experts * (me * counts).sum()
    zloss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return top_p, top_i, {"moe_aux": aux, "moe_zloss": zloss}


def moe_forward_dense(params: dict, x: torch.Tensor, dims: MoEDims,
                      policy: PrecisionPolicy) -> Tuple[torch.Tensor, dict]:
    """All experts on all tokens: three batched expert launches, then the
    gated combine and the shared experts."""
    B, S, D = x.shape
    x2 = x.reshape(-1, D)
    top_p, top_i, aux = _route(x2, params["router"], dims, policy)

    mode = policy.mode("moe_expert")
    bwd = policy.bwd_kwargs("moe_expert")
    g = mp_matmul(x2, params["w_gate"], mode, **bwd)         # (E, T, F)
    u = mp_matmul(x2, params["w_up"], mode, **bwd)
    all_out = mp_matmul(torch.nn.functional.silu(g) * u, params["w_down"],
                        mode, **bwd)                         # (E, T, D)
    gates = torch.zeros((x2.shape[0], dims.n_experts), device=x.device)
    gates = gates.scatter(1, top_i, top_p)
    out = torch.einsum("te,etd->td", gates, all_out).reshape(B, S, D)
    out = out + _shared_out(params, x, dims, policy)
    return out, aux


def _shared_out(params: dict, x: torch.Tensor, dims: MoEDims,
                policy: PrecisionPolicy) -> torch.Tensor:
    if dims.n_shared == 0:
        return torch.zeros_like(x)
    sp = params["shared"]
    return swiglu_mlp(x, sp["w_gate"], sp["w_up"], sp["w_down"], policy,
                      op_class="moe_expert")


def moe_forward(params: dict, x: torch.Tensor, dims: MoEDims,
                policy: PrecisionPolicy, mesh=None
                ) -> Tuple[torch.Tensor, dict]:
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE over a mesh (moe_forward_ep) is not ported "
            "yet; see ROADMAP.md Queue 1, the family-training slice")
    return moe_forward_dense(params, x, dims, policy)
