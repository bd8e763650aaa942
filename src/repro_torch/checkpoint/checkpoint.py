"""Fault-tolerant checkpointing (port of ``repro.checkpoint.checkpoint``):
an atomic ``.npz`` plus a JSON manifest per step.

  * atomicity — writes go to ``step_<N>.tmp`` then ``os.replace`` (a crashed
    writer never corrupts the latest checkpoint);
  * manifest — step, leaf paths, shapes and dtypes; restore validates the
    structure before touching arrays;
  * retention — keep the last N checkpoints, delete older ones;
  * resume discovery — ``latest_step`` scans the directory.

Leaves are the port's tensors (any device; saved from the host); a tree is
nested dicts, lists and tuples (NamedTuples by position, as in the JAX
package).  bf16 leaves are stored as their raw 16-bit patterns, with the
logical dtype in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    """Atomically save a tree at ``ckpt_dir/step_<N>``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "extra": extra_meta or {}}
    arrays = {}
    for i, (path, leaf) in enumerate(sorted(tree_lib.items(tree))):
        arr, logical = _to_numpy(leaf)
        key = f"a{i:06d}"
        arrays[key] = arr
        manifest["leaves"][path] = {"key": key, "shape": list(arr.shape),
                                    "dtype": logical}
    np.savez(os.path.join(tmp, "shard_host0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _from_numpy(arr: np.ndarray, logical: str, like) -> torch.Tensor:
    if logical == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def restore(ckpt_dir: str, step: int, like: Any,
            shardings: Optional[Any] = None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like``; each leaf lands on the device
    of ``like``'s leaf at its path, with the saved dtype.

    ``shardings`` (a tree of ``dist.sharding.Sharding``, e.g. from
    ``param_shardings``): each leaf comes back as a ``DTensor`` on that
    sharding's mesh — elastic restore of a logically saved checkpoint onto
    any world.  Every rank reads the checkpoint and keeps its own shard
    (``distribute_tensor(..., src_data_rank=None)``): no communication."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = dict(tree_lib.items(like))
    missing = set(flat_like) - set(manifest["leaves"])
    extra = set(manifest["leaves"]) - set(flat_like)
    if missing or extra:
        raise ValueError(f"checkpoint structure mismatch: missing="
                         f"{sorted(missing)[:5]} extra={sorted(extra)[:5]}")
    with np.load(os.path.join(path, "shard_host0.npz")) as data:
        arrays = {p: data[m["key"]] for p, m in manifest["leaves"].items()}
    placed = dict(tree_lib.items(shardings)) if shardings is not None \
        else None

    def rebuild(prefix, node):
        def join(k):  # tree_lib.items' paths
            return f"{prefix}/{k}" if prefix else str(k)

        if isinstance(node, dict):
            return {k: rebuild(join(k), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [rebuild(join(i), v) for i, v in enumerate(node)]
            if isinstance(node, list):
                return out
            return type(node)(*out) if hasattr(node, "_fields") \
                else type(node)(out)
        meta = manifest["leaves"][prefix]
        arr = arrays[prefix]
        if tuple(arr.shape) != tuple(np.shape(node)):
            raise ValueError(f"shape mismatch at {prefix}: {arr.shape} vs "
                             f"{tuple(np.shape(node))}")
        t = _from_numpy(arr, meta["dtype"], node)
        if placed is None:
            return t
        from torch.distributed.tensor import distribute_tensor

        sh = placed[prefix]
        return distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                 sh.placements(), src_data_rank=None)

    return rebuild("", like), manifest["extra"]
