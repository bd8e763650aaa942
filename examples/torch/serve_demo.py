"""Serving demo: batched requests through the ServeEngine with the paper's
precision dial — compare serve_default (mode-2 decode) with AUTO (mode 1);
then a policy hot-swap, the continuous scheduler with per-request modes and
a two-cell fleet (the PyTorch port of examples/serve_demo.py).

    PYTHONPATH=src python examples/torch/serve_demo.py               # card
    PYTHONPATH=src python examples/torch/serve_demo.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.fleet import FleetRouter, make_fleet
from repro_torch.serve.scheduler import ContinuousScheduler, ScheduledRequest


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = ap.parse_args().device

    cfg = get_config("paper-mpfp-100m", smoke=True)
    params = T.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 3, 7, 2)]

    for name, pol in [("mode2 (M8 decode)", PrecisionPolicy.serve_default()),
                      ("mode1 (AUTO)", PrecisionPolicy.auto())]:
        eng = ServeEngine(cfg, params, max_batch=4, max_seq=64, policy=pol,
                          device=dev)
        outs = eng.generate(prompts, max_new=8)
        stats = eng.decode_throughput_probe(steps=4)
        print(f"policy={name}")
        for i, o in enumerate(outs):
            print(f"  req{i}: {o}")
        print(f"  decode throughput: {stats['tokens_per_s']:.0f} tok/s "
              f"({stats['ms_per_step']:.1f} ms/step, batch 4, {dev})")

    # run-time policy hot-swap: the serving control plane ships a JSON
    # policy (PrecisionPolicy.to_json wire format) and the engine re-points
    # its steps — no engine rebuild, KV caches survive
    eng = ServeEngine(cfg, params, max_batch=4, max_seq=64,
                      policy=PrecisionPolicy.serve_default(), device=dev)
    eng.set_policy(PrecisionPolicy.full_fp32().to_json())
    outs = eng.generate(prompts[:2], max_new=4)
    print(f"after set_policy(full_fp32 JSON): {outs}")

    # continuous batching with per-request QoS: requests carry their own
    # precision mode, join the decode batch on arrival, evict on EOS, and
    # recycle paged KV blocks — the paper's mode table per request
    sched = ContinuousScheduler(eng, n_blocks=32, block_size=8)
    done = sched.run([
        ScheduledRequest(rid=0, prompt=prompts[0], max_new=6, mode="M8"),
        ScheduledRequest(rid=1, prompt=prompts[1], max_new=6, mode="M23"),
        ScheduledRequest(rid=2, prompt=prompts[2], max_new=4, arrival=2),
    ])
    print("continuous scheduler (per-request modes):")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req{r.rid} [{r.mode or 'engine-default'}] "
              f"admit@{r.admitted_step} done@{r.done_step}: {r.out}")
    print(f"  {sched.stats()}")

    # fleet serving: the same requests over two cells — prefill cells hand
    # paged KV blocks to decode cells (no recompute), the router pins each
    # mode to a home cell, and finished requests fan back out to their
    # submitter's completion queue
    cells = make_fleet(eng, 2, n_blocks=32, block_size=8)
    router = FleetRouter(cells, policy="mode_affinity")
    router.run([
        ScheduledRequest(rid=0, prompt=prompts[0], max_new=6, mode="M8",
                         submitter="alice"),
        ScheduledRequest(rid=1, prompt=prompts[1], max_new=6, mode="M23",
                         submitter="bob"),
        ScheduledRequest(rid=2, prompt=prompts[2], max_new=4, arrival=2,
                         submitter="alice"),
    ])
    print("fleet router (2 cells, mode_affinity):")
    for who in ("alice", "bob"):
        for r in router.drain(who):
            print(f"  {who}: req{r.rid} [{r.mode or 'engine-default'}] "
                  f"cell{r.engine_id}: {r.out}")
    print(f"  {router.stats()}")


if __name__ == "__main__":
    main()
