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

A tree laid out across ranks (an FSDP layout, ``dist/fsdp.py``: each rank
holds its blocks) is saved as its global arrays — gathered one leaf at a
time, each written by rank 0 before the next is gathered — so it is the
file a one-rank run writes, and restores onto one rank or onto any
layout's blocks (``restore(shardings=..., local=True)``).  The ``.npz`` is
written a leaf at a time (``np.savez``'s layout: an uncompressed zip of
``.npy`` members) and read a leaf at a time, each mapped from the file, so
a rank's block copies only its own bytes.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import zipfile
from typing import Any, Callable, Optional, Tuple

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
         extra_meta: Optional[dict] = None,
         shardings: Optional[Any] = None) -> str:
    """Atomically save a tree at ``ckpt_dir/step_<N>``.

    ``shardings`` (a tree of ``dist.sharding.Sharding``, ``tree`` this
    rank's blocks under them): every rank gathers the global arrays a leaf
    at a time (collective), rank 0 writes each before the next is
    gathered, so a rank holds at most one whole leaf beyond its blocks;
    no rank returns before the checkpoint is published."""
    items = sorted(tree_lib.items(tree))
    if shardings is None:
        _write(ckpt_dir, step, items, keep, extra_meta)
    else:
        import torch.distributed as dist

        from repro_torch.dist import fsdp

        placed = dict(tree_lib.items(shardings))
        whole = ((p, fsdp.full_leaf(x, placed[p])) for p, x in items)
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, whole, keep, extra_meta)
        else:
            for _ in whole:
                pass
        dist.barrier()
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def _write(ckpt_dir: str, step: int, items, keep: int,
           extra_meta: Optional[dict]) -> None:
    """Write the (path, leaf) pairs of ``items`` (sorted by path) as one
    step, each leaf on the host only while it is written."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "extra": extra_meta or {}}
    with zipfile.ZipFile(os.path.join(tmp, "shard_host0.npz"), "w",
                         zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, (path, leaf) in enumerate(items):
            arr, logical = _to_numpy(leaf)
            key = f"a{i:06d}"
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
            manifest["leaves"][path] = {"key": key, "shape": list(arr.shape),
                                        "dtype": logical}
            del arr, leaf
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _retain(ckpt_dir, keep)


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


def _reader(npz_path: str) -> Callable[[str], np.ndarray]:
    """``read(key)``: the array a ``.npz`` member holds, mapped from the
    file (``np.memmap``) where the member is stored uncompressed and not
    empty, so a slice of it reads only its own bytes; else read whole."""
    mapped = {}
    with zipfile.ZipFile(npz_path) as zf, open(npz_path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                continue
            f.seek(info.header_offset)
            n_name, n_extra = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if dtype.hasobject or not np.prod(shape, dtype=np.int64):
                continue
            mapped[info.filename[:-len(".npy")]] = (
                f.tell(), shape, "F" if fortran else "C", dtype)

    def read(key: str) -> np.ndarray:
        if key not in mapped:
            with np.load(npz_path) as data:
                return data[key]
        offset, shape, order, dtype = mapped[key]
        return np.memmap(npz_path, dtype=dtype, mode="r", offset=offset,
                         shape=shape, order=order)

    return read


def restore(ckpt_dir: str, step: int, like: Any,
            shardings: Optional[Any] = None,
            local: bool = False) -> Tuple[Any, dict]:
    """Restore into the structure of ``like``; each leaf lands on the device
    of ``like``'s leaf at its path, with the saved dtype.

    ``shardings`` (a tree of ``dist.sharding.Sharding``, e.g. from
    ``param_shardings``): each leaf comes back as a ``DTensor`` on that
    sharding's mesh — elastic restore of a logically saved checkpoint onto
    any world.  Every rank reads the checkpoint and keeps its own shard
    (``distribute_tensor(..., src_data_rank=None)``): no communication.
    With ``local`` each leaf comes back as this rank's block, a plain
    tensor in JAX's block order (``dist.sharding.shard``), and ``like``
    holds the blocks' shapes (an FSDP layout's state)."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = dict(tree_lib.items(like))
    missing = set(flat_like) - set(manifest["leaves"])
    extra = set(manifest["leaves"]) - set(flat_like)
    if missing or extra:
        raise ValueError(f"checkpoint structure mismatch: missing="
                         f"{sorted(missing)[:5]} extra={sorted(extra)[:5]}")
    read = _reader(os.path.join(path, "shard_host0.npz"))
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
        want = tuple(meta["shape"])
        if placed is not None and local:
            from repro_torch.dist import sharding as sh_lib

            want = sh_lib.local_shape(placed[prefix], want)
        if want != tuple(np.shape(node)):
            raise ValueError(f"shape mismatch at {prefix}: {want} vs "
                             f"{tuple(np.shape(node))}")
        arr = read(meta["key"])
        if placed is not None and local:
            if arr.ndim:
                arr = arr[sh_lib.block(placed[prefix], arr.shape)]
            return _from_numpy(arr, meta["dtype"], node)
        t = _from_numpy(arr, meta["dtype"], node)
        if placed is None:
            return t
        from torch.distributed.tensor import distribute_tensor

        sh = placed[prefix]
        return distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                 sh.placements(), src_data_rank=None)

    return rebuild("", like), manifest["extra"]
