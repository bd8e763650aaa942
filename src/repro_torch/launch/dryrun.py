"""Dry run of every (architecture x input shape x mesh) cell on ``meta``
tensors (port of ``repro.launch.dryrun``, which lowers and compiles each
cell for 256 / 512 placeholder TPU devices).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --mesh single           # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --cells deepseek-7b:decode_32k,mamba2-130m:long_500k

Each cell runs the port's own step (``launch/specs.build_cell``) once, as
rank 0 of a world of 256 (``single``: the (16, 16) ``(data, model)`` mesh)
or 512 (``multi``: (2, 16, 16) ``(pod, data, model)``) ranks joined by
PyTorch's fake process group: ``launch.mesh.make_production_mesh`` and the
``sharded`` backend run unchanged, their collectives counted
(``dist.collectives``) and not sent.  The arguments are ``meta`` tensors
at the cell's full config and shape, and every kernel wrapper returns its
output's shape on ``meta``, so nothing is allocated and nothing computed;
the work the step would run on this rank is counted at dispatch
(``analysis.accounting``).

One JSON record per cell lands in ``build/dryrun/<mesh>_<arch>_<shape>.json``:
``status`` ``ok``, or ``skip`` with the reason (the shape does not apply to
the arch, as ``configs.shapes.applicability`` decides; or the port's path
does not run on meta tensors or the fake group, with the error), the JAX
layout decisions (``make_rules``) with ``layout.ported`` (true where the
step ran on the rank's blocks: a train cell under pure FSDP rules without
MoE layers, ``specs.fsdp_layout``; a decode cell without MoE layers or
TP, ``specs.decode_layout``: its rows and cache blocks, its parameters'
FSDP blocks where the batch has axes, all-gathers over them and three
all-reduces an attention layer over the sequence group; and a train or
prefill cell under the small-batch rules without MoE layers or TP,
``specs.seq_layout``, the Ulysses layout: its rows with the whole
sequence, its parameter blocks over the batch axes, a prefill's cache
blocks, the all-to-alls (or K / V all-gathers) over ``model`` and the
SSM's send / recv), ``n_chips``,
``trace_s`` (the seconds of the meta run: eager PyTorch has no lowering or
compile), ``memory`` (per rank: the argument bytes by group, params,
optimizer state, cache and batch, and the output bytes; ``peak_bytes`` is
null, since a meta run allocates nothing and records no temporaries, and
eager PyTorch frees activations as it goes), ``work`` (FLOPs, bytes, collective bytes by kind, per rank) and
``roofline`` (the H100 SXM's constants, NVLink as the link).  The records
show what the port holds: a ported cell's blocks (Σ over leaves of the
block's numel × item size) and rows, every other cell's whole parameters,
state, cache and batch on every rank.  (A decode cell's ``length`` is a
Python int in the port: JAX's records count its int32 leaves, 4 bytes a
layer, which the port's do not.)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.analysis import accounting
from repro_torch.analysis import roofline as rl
from repro_torch.configs.registry import assigned_archs, get_config
from repro_torch.configs.shapes import SHAPES, SHAPE_ORDER, applicability
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ART_DIR = os.path.join(ROOT, "build", "dryrun")
WORLDS = {False: 256, True: 512}


def nbytes(obj) -> int:
    """Bytes of every tensor in a tree (dicts, lists, tuples, dataclasses,
    the caches)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(nbytes(v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return sum(nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def join_fake_world(world: int) -> None:
    """Rank 0 of a ``world``-rank fake process group (collectives are
    no-ops); leaves any earlier group first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.dist import collectives

    mesh_lib.shutdown()
    collectives._GROUPS.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _write(rec: dict, out_dir: str, tag: str = "") -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(
        out_dir, f"{rec['mesh']}_{rec['arch']}_{rec['shape']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, *,
             policy_name: Optional[str] = None, tag: str = "") -> dict:
    """Run one cell as rank 0 of the fake world (joined by the caller) and
    write its record."""
    mesh_name = "multipod" if multi_pod else "singlepod"
    cfg = get_config(arch)
    ok, reason = applicability(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "skip", "reason": reason}
    if tag:
        rec["tag"] = tag
    if not ok:
        _write(rec, out_dir, tag)
        return rec
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    n_chips = 1
    for v in mesh_lib.mesh_axes(mesh).values():
        n_chips *= v
    policy = None
    if policy_name:
        from repro_torch.core.policy import get_policy
        policy = get_policy(policy_name)
    try:
        cell = specs_lib.build_cell(arch, cfg, shape_name, mesh,
                                    policy=policy)
        t0 = time.perf_counter()
        with accounting.count_work() as work:
            out = cell.fn(*cell.args)
        trace_s = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 - the record says why
        rec["reason"] = (f"the port's path does not run on meta tensors or "
                         f"the fake group: {type(e).__name__}: "
                         f"{str(e)[:300]}")
        rec["error"] = True
        _write(rec, out_dir, tag)
        return rec
    scell = SHAPES[shape_name]
    mf = rl.model_flops(cfg, scell.phase, scell.seq_len, scell.global_batch)
    groups = {k: nbytes(v) for k, v in cell.groups.items()}
    rules = cell.rules
    rec.update({
        "status": "ok",
        "reason": "",
        "n_chips": n_chips,
        "trace_s": trace_s,
        "layout": {"batch_axes": [a for a in rules.batch_axes if a],
                   "seq_axes": list(rules.seq_axes),
                   "tp_enabled": rules.tp_enabled,
                   "ported": cell.layout is not None},
        "memory": {
            **{f"{k}_bytes": v for k, v in groups.items()},
            "argument_bytes": sum(groups.values()),
            "output_bytes": nbytes(out),
            "peak_bytes": None,
        },
        "work": work.summary(),
        "roofline": rl.from_work(work, n_chips=n_chips,
                                 model_flops_global=mf).to_dict(),
    })
    _write(rec, out_dir, tag)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--tag", default="", help="artifact suffix for perf iters")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--cells", default="",
                    help="comma-separated arch:shape pairs (instead of "
                         "--arch / --shape / --all)")
    args = ap.parse_args(argv)

    archs = assigned_archs() if (args.all or not args.arch) else [args.arch]
    shapes = SHAPE_ORDER if (args.all or not args.shape) else [args.shape]
    pairs = [(a, s) for a in archs for s in shapes]
    if args.cells:
        pairs = [tuple(c.split(":")) for c in args.cells.split(",")]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.list:
        for a, s in pairs:
            ok, reason = applicability(get_config(a), s)
            print(f"{a:24s} {s:12s} {'RUN' if ok else 'SKIP: ' + reason}")
        return

    failures = []
    try:
        for mp in meshes:
            join_fake_world(WORLDS[mp])
            mesh_name = "multipod" if mp else "singlepod"
            for a, s in pairs:
                try:
                    rec = run_cell(a, s, mp, args.out,
                                   policy_name=args.policy, tag=args.tag)
                except Exception as e:  # noqa: BLE001
                    failures.append((mesh_name, a, s, repr(e)))
                    print(f"FAIL {mesh_name:9s} {a:24s} {s:12s} {e!r}",
                          flush=True)
                    traceback.print_exc()
                    continue
                if rec["status"] == "ok":
                    r, m = rec["roofline"], rec["memory"]
                    print(f"OK   {mesh_name:9s} {a:24s} {s:12s} "
                          f"trace={rec['trace_s']:6.2f}s "
                          f"args={m['argument_bytes'] / 2**30:9.2f}GiB "
                          f"bound={r['dominant']:10s} "
                          f"t={r['bound_s'] * 1e3:12.2f}ms "
                          f"mfu_bound={r['mfu_bound']:.4f}", flush=True)
                else:
                    print(f"SKIP {mesh_name:9s} {a:24s} {s:12s} "
                          f"({rec['reason']})", flush=True)
    finally:
        mesh_lib.shutdown()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         f"{[(m, a, s) for m, a, s, _ in failures]}")


if __name__ == "__main__":
    main()
