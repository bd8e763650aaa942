"""A pool of gloo ranks for the port's distributed CPU tests.

A test module starts its ranks once (a module-scoped fixture) and runs named
cases on them: every rank calls the same function of
``tests/torch_dist_cases.py`` with the same arguments, and the results come
back as a list in rank order.  The ranks are spawned processes (no JAX:
the cases import the port alone) that join through a ``file://``
rendezvous in the test's temporary directory, with a timeout on the process
group, so a rank that never arrives fails the others.  Every wait has a
deadline; a case that fails or times out on any rank takes the pool down
(each rank still alive is killed) and the next case starts a fresh one.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
GROUP_TIMEOUT_S = 90.0


def _worker(rank: int, world: int, init_file: str, inq, outq) -> None:
    sys.path.insert(0, HERE)
    try:
        import torch

        torch.set_num_threads(1)
        from repro_torch.launch import mesh as mesh_lib

        mesh_lib.init_distributed(rank, world,
                                  init_method=f"file://{init_file}",
                                  device="cpu", timeout_s=GROUP_TIMEOUT_S)
        import torch_dist_cases as cases
    except BaseException:  # report any start-up failure, then stop
        outq.put((rank, False, traceback.format_exc()))
        return
    outq.put((rank, True, "ready"))
    while True:
        item = inq.get()
        if item is None:
            break
        name, args = item
        try:
            outq.put((rank, True, getattr(cases, name)(*args)))
        except BaseException:
            outq.put((rank, False, traceback.format_exc()))
    mesh_lib.shutdown()


class RankPool:
    """``world`` gloo ranks on the CPU running cases on request."""

    def __init__(self, world: int, tmp_dir: str, timeout: float = 120.0):
        self.world, self.tmp_dir, self.timeout = world, tmp_dir, timeout
        self._n = 0
        self.procs = []

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._n += 1
        init_file = os.path.join(self.tmp_dir, f"rendezvous_{self._n}")
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(self.world)]
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, self.world, init_file,
                                        self.inqs[r], self.outq))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()
        self._collect("start-up")

    def _collect(self, what: str):
        got = {}
        try:
            while len(got) < self.world:
                rank, ok, res = self.outq.get(timeout=self.timeout)
                if not ok:
                    raise AssertionError(f"rank {rank} failed in {what}:\n"
                                         f"{res}")
                got[rank] = res
        except queue.Empty:
            self.close()
            raise AssertionError(f"{what}: ranks {sorted(set(range(self.world)) - set(got))} "
                                 f"gave no result in {self.timeout} s")
        except AssertionError:
            self.close()
            raise
        return [got[r] for r in range(self.world)]

    def run(self, case: str, *args):
        """Run ``torch_dist_cases.<case>(*args)`` on every rank; the results
        in rank order."""
        if not self.procs:
            self._start()
        for q in self.inqs:
            q.put((case, args))
        return self._collect(case)

    def close(self) -> None:
        for q in getattr(self, "inqs", []):
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self.procs = []
