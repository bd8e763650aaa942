"""Parameters and optimizer state from the JAX package, so both packages
compute the same thing.

``params_from_jax`` takes the JAX ``init_params`` tree with its leaves
converted to numpy (``jax.tree_util.tree_map(np.asarray, params)``) — the
stacked ``(L, ...)`` layer leaves become the port's list of per-layer dicts.
A gradient tree has the params' structure and maps the same way;
``adamw_state_from_jax`` carries an AdamW state (step, m, v) across with
that mapping.  No jax is imported here: the caller converts.
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


def params_from_jax(tree: dict, device="cpu") -> dict:
    """JAX dense-family params (numpy leaves) -> the port's params; also
    any tree of that structure (gradients, AdamW moments)."""
    layers_np = tree["layers"]
    n_layers = np.asarray(layers_np["ln1"]["w"]).shape[0]

    def layer(i):
        return {group: {name: _tensor(np.asarray(leaf)[i], device)
                        for name, leaf in leaves.items()}
                for group, leaves in layers_np.items()}

    return {
        "embed": {"table": _tensor(tree["embed"]["table"], device)},
        "layers": [layer(i) for i in range(n_layers)],
        "ln_final": {"w": _tensor(tree["ln_final"]["w"], device)},
        "lm_head": {"w": _tensor(tree["lm_head"]["w"], device)},
    }


def adamw_state_from_jax(step, m: dict, v: dict, device="cpu") -> AdamWState:
    """A JAX ``AdamWState`` (its step and moment trees with numpy leaves)
    -> the port's, the moments mapped as :func:`params_from_jax` maps the
    params (their dtype kept: f32 or bf16)."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        m=params_from_jax(m, device), v=params_from_jax(v, device))
