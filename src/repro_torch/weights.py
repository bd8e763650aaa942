"""Parameters from the JAX package, so both packages compute the same thing.

``params_from_jax`` takes the JAX ``init_params`` tree with its leaves
converted to numpy (``jax.tree_util.tree_map(np.asarray, params)``) — the
stacked ``(L, ...)`` layer leaves become the port's list of per-layer dicts.
No jax is imported here: the caller converts.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), device=device)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """JAX dense-family params (numpy leaves) -> the port's params."""
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
