"""Parameters and optimizer state from the JAX package, so both packages
compute the same thing.

``params_from_jax`` takes the JAX ``init_params`` tree of any family with
its leaves converted to numpy (``jax.tree_util.tree_map(np.asarray,
params)``) — the stacked ``(L, ...)`` layer leaves become the port's lists
of per-layer dicts.
A gradient tree has the params' structure and maps the same way;
``adamw_state_from_jax`` carries an AdamW state (step, m, v) across with
that mapping, and ``cache_from_jax`` a decode cache (the stacked
``ModelCache``) as the port's per-layer one.  No jax is imported here: the
caller converts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: the raw bits
        bits = torch.from_numpy(x.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(x, copy=True), device=device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree)


def _unstack(tree: dict, device, lead: int = 1) -> list:
    """A tree of stacked leaves -> the list of its per-layer trees; the
    ``lead`` leading dims (the hybrid's (G, every)) flatten into one."""
    def flat(x):
        x = np.asarray(x)
        return x.reshape((-1,) + x.shape[lead:])

    n = flat(_first_leaf(tree)).shape[0]
    return [_map(tree, lambda x, i=i: _tensor(flat(x)[i], device))
            for i in range(n)]


def params_from_jax(tree: dict, device="cpu") -> dict:
    """JAX params of any family (numpy leaves) -> the port's params; also
    any tree of that structure (gradients, AdamW moments).  Stacked layer
    groups become lists of per-layer dicts: ``layers`` and ``dense_layers``
    (L, ...), the hybrid's ``layers`` (G, every, ...) flattened to its L
    Mamba2 layers in order and its ``shared_lora`` (G, ...) to one dict per
    group; every other leaf (embed, ``shared_block``, the norms, the
    ``lm_head`` or audio's ``ctc_head``) is carried as it is."""
    hybrid = "shared_block" in tree
    out = {}
    for key, sub in tree.items():
        if key == "layers":
            out[key] = _unstack(sub, device, lead=2 if hybrid else 1)
        elif key in ("dense_layers", "shared_lora"):
            out[key] = _unstack(sub, device)
        else:
            out[key] = _map(sub, lambda x: _tensor(x, device))
    return out


def adamw_state_from_jax(step, m: dict, v: dict, device="cpu") -> AdamWState:
    """A JAX ``AdamWState`` (its step and moment trees with numpy leaves)
    -> the port's, the moments mapped as :func:`params_from_jax` maps the
    params (their dtype kept: f32 or bf16)."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        m=params_from_jax(m, device), v=params_from_jax(v, device))


def cache_from_jax(cache, device="cpu"):
    """A JAX decode cache of any family (its ``ModelCache`` with numpy
    leaves: ``jax.tree_util.tree_map(np.asarray, cache)``) -> the port's
    ``ModelCache`` of per-layer caches.  Each stacked group (``attn``,
    ``dense_attn``, ``shared_attn`` (L, ...); the hybrid's ``ssm``
    (G, every, ...) flattened to its L layers in order) becomes a list of
    ``KVCache`` / ``MLACache`` / ``SSMCache``, by its fields; the int32
    ``length`` leaves become the Python int each layer's holds."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache
    from repro_torch.models.mla import MLACache
    from repro_torch.models.ssm import SSMCache

    kinds = {"k": KVCache, "c_kv": MLACache, "conv": SSMCache}

    def layers(group):
        if group is None:
            return None
        kind = next(kinds[f] for f in group._fields if f in kinds)
        lead = np.asarray(group.length).ndim
        flat = {f: np.asarray(getattr(group, f)) for f in group._fields}
        flat = {f: x.reshape((-1,) + x.shape[lead:])
                for f, x in flat.items()}
        return [kind(**{f: int(x[i]) if f == "length"
                        else _tensor(x[i], device)
                        for f, x in flat.items()})
                for i in range(flat["length"].shape[0])]

    return T.ModelCache(attn=layers(cache.attn),
                        dense_attn=layers(cache.dense_attn),
                        ssm=layers(cache.ssm),
                        shared_attn=layers(cache.shared_attn))
