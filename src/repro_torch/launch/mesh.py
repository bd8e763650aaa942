"""Process groups and device meshes (port of ``repro.launch.mesh``).

JAX sees every device of its job at import; PyTorch joins its ranks
explicitly, so this module adds :func:`init_distributed`, the one place a
process enters the job.  The meshes are ``torch.distributed`` DeviceMeshes
over the initialized world:

  make_matmul_mesh      1-D, every rank, for the sharded mp_matmul backend
                        (core/dispatch.py): the contraction dim shards over
                        its axis, the per-order partials all-reduce over it;
  make_debug_mesh       (data, model) or (pod, data, model), small worlds;
  make_production_mesh  the (16, 16) / (2, 16, 16) layouts, only on a world
                        of that size.

Backend rule (:func:`pick_backend`): ``nccl`` when the ranks run on ``cuda``
and every rank of a host has its own card, ``gloo`` otherwise (CPU ranks,
or ranks sharing one card, which NCCL refuses).  A caller that asks for
``nccl`` where the rule gives ``gloo`` gets an error, never gloo.

Importing this module touches no device and no process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class DistInfo:
    """What :func:`init_distributed` set up for this process."""

    rank: int
    world_size: int
    local_rank: int
    backend: str
    device: torch.device


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def pick_backend(device: str, local_world: int,
                 requested: Optional[str] = None) -> str:
    """The backend rule: ``nccl`` on ``cuda`` with a card per local rank,
    ``gloo`` otherwise.  ``requested`` must agree with the rule where it
    names ``nccl``; ``gloo`` may always be asked for."""
    own_card = (device == "cuda" and torch.cuda.is_available()
                and local_world <= torch.cuda.device_count())
    rule = "nccl" if own_card else "gloo"
    if requested in (None, "", rule):
        return rule
    if requested == "gloo":
        return "gloo"
    if requested == "nccl":
        raise RuntimeError(
            f"nccl needs one card per rank on cuda: device={device!r}, "
            f"{local_world} local ranks, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" cards")
    raise ValueError(f"unknown backend {requested!r}")


def init_distributed(rank: Optional[int] = None,
                     world_size: Optional[int] = None, *,
                     init_method: Optional[str] = None,
                     device: str = "cuda", backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> DistInfo:
    """Join the job's default process group.

    Rank and world come from the arguments, else from torchrun's
    environment (``RANK``, ``WORLD_SIZE``; ``MASTER_ADDR`` /
    ``MASTER_PORT`` through the ``env://`` rendezvous when no
    ``init_method`` is given), the local rank and the ranks on this host
    from ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` (default: the rank, the
    world: one host).  Tests pass a
    ``file://`` ``init_method``: no port to collide on.  ``timeout_s``
    bounds every collective of the group, so a rank that never arrives
    fails the others instead of hanging them.  On ``cuda`` the process is
    bound to card ``local_rank % device_count``."""
    rank = rank if rank is not None else _env_int("RANK")
    world_size = world_size if world_size is not None \
        else _env_int("WORLD_SIZE")
    if rank is None or world_size is None:
        raise ValueError("init_distributed needs rank and world_size "
                         "(arguments, or torchrun's RANK / WORLD_SIZE)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed(device='cuda') needs a CUDA "
                           "device; pass device='cpu' for gloo on the CPU")
    name = pick_backend(device, local_world, backend)
    dev = torch.device("cpu")
    if device == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        raise RuntimeError("the default process group is already "
                           "initialized")
    kw = {}
    if name == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        backend=name, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _MESHES.clear()
    _INFO[0] = DistInfo(rank, world_size, local_rank, name, dev)
    return _INFO[0]


def join_from_env(device: str = "cuda") -> Optional[DistInfo]:
    """The launchers' entry: under torchrun (``WORLD_SIZE`` > 1) join the
    process group from its environment; None for a single process."""
    if (_env_int("WORLD_SIZE") or 1) <= 1:
        return None
    return init_distributed(device=device)


def rank0_prints(info: Optional[DistInfo]):
    """A scope in which only rank 0 of a job writes to stdout (the
    launchers' output; a single process prints)."""
    if info is None or info.rank == 0:
        return contextlib.nullcontext()
    return contextlib.redirect_stdout(io.StringIO())


def check_same_on_every_rank(obj, what: str) -> None:
    """Raise unless every rank's ``obj`` equals rank 0's (a no-op without
    a process group)."""
    if not dist.is_initialized():
        return
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    bad = [r for r, o in enumerate(got) if o != got[0]]
    if bad:
        raise RuntimeError(f"{what} of ranks {bad} differ from rank 0's")


def dist_info() -> Optional[DistInfo]:
    """This process's :class:`DistInfo`, or None before
    :func:`init_distributed` (or after :func:`shutdown`)."""
    return _INFO[0] if dist.is_initialized() else None


def shutdown() -> None:
    """Leave the default process group (and drop the cached meshes)."""
    _MESHES.clear()
    _INFO[0] = None
    if dist.is_initialized():
        dist.destroy_process_group()


# the process's one DistInfo, as the process group is the process's one
_INFO: list = [None]


def _device_type() -> str:
    info = dist_info()
    return info.device.type if info is not None else "cpu"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (JAX's ``mesh.shape``)."""
    names = mesh.mesh_dim_names or tuple(f"dim{i}"
                                         for i in range(mesh.ndim))
    return dict(zip(names, mesh.shape))


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    key = (shape, names, id(dist.group.WORLD))
    cached = _MESHES.get(key)
    if cached is None:
        from torch.distributed.device_mesh import init_device_mesh

        cached = init_device_mesh(_device_type(), shape,
                                  mesh_dim_names=names)
        _MESHES[key] = cached
    return cached


_MESHES: dict = {}


def make_matmul_mesh(n_devices: int = 0, axis: str = "data"):
    """1-D mesh for the sharded mp_matmul backend (core/dispatch.py) over
    ``n_devices`` ranks (default: the whole world).  Cached per
    (n, axis, process group), so repeated calls share one mesh and one
    set of groups (creating a group is itself collective)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    n = n_devices or dist.get_world_size()
    return _mesh((n,), (axis,))


def make_debug_mesh(data: int = 2, model: int = 4, pod: int = 0):
    """Small (data, model) or (pod, data, model) mesh."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"))
    return _mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The production layouts: (16, 16) (data, model) or (2, 16, 16)
    (pod, data, model); raises unless the world is that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(f"the production mesh {shape} needs {need} "
                           f"ranks; the world has {world}")
    return _mesh(shape, names)
