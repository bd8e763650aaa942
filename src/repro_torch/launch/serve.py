"""Serving launcher (port of ``repro.launch.serve``): batched generation
with the precision dial.

Static path (one batch, one policy):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
        --policy serve_default --requests 4 --max-new 16

Continuous-batching path (paged KV pool, Poisson request stream, per-request
precision modes — the paper's mode table as per-request QoS):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --scheduler \\
        --requests 12 --mixed-modes

Fleet path (N engine cells behind the mode-aware router, disaggregated
prefill/decode with paged-KV handoff — serve/fleet/):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --engines 4 \\
        --disaggregate --router-policy mode_affinity --requests 16 \\
        --mixed-modes

Chaos path (deterministic fault injection against the fleet — kill cells,
poison decode steps, fail handoffs — per a JSON plan; see serve/faults.py):

    PYTHONPATH=src python -c "from repro_torch.serve.faults import \\
        FaultPlan; open('plan.json', 'w').write(FaultPlan.chaos(seed=0, \\
        n_cells=4).to_json())"
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --engines 4 \\
        --requests 16 --fault-plan plan.json

Across ranks (the ``sharded`` backend: each matmul K-sharded over the
ranks, decode attention sequence-parallel; every rank serves the same
requests, rank 0 prints, and every rank checks that its tokens equal rank
0's):

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --smoke --backend sharded --device cpu

(gloo on the CPU or on ranks sharing one card; NCCL with a card per rank.)

Runs on the card unless ``--device cpu`` is given (every kernel wrapper
then runs its plain version); without a card and without ``--device cpu``
it stops.  ``--arch`` takes every id of ``configs/registry.py`` (``--smoke``
for its CI-sized config); an encoder-only arch has no decode to serve and
exits, and so does a full config above 1e9 parameters on the CPU.  The
scheduler and the fleet serve the dense GQA family only, as in the JAX
package.  Weights are random, from seed 0.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --smoke --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.policy import POLICIES, get_policy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-mpfp-100m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--policy", default="serve_default",
                    choices=sorted(POLICIES))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--backend", default="",
                    help="mp_matmul dispatch backend (cuda/ref/sharded); "
                         "'' = the context's default")
    ap.add_argument("--scheduler", action="store_true",
                    help="continuous-batching scheduler (paged KV pool, "
                         "join-on-arrival/evict-on-EOS) instead of the "
                         "static generate() batch")
    ap.add_argument("--mixed-modes", action="store_true",
                    help="scheduler/fleet: give requests rotating "
                         "per-request precision modes (M8/M16/M23)")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="scheduler/fleet: Poisson mean arrivals per tick "
                         "of the simulated request stream")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="scheduler/fleet: paged pool size in blocks per "
                         "pool (0 = sized from --requests)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="scheduler/fleet: tokens per KV block")
    ap.add_argument("--engines", type=int, default=0,
                    help="fleet mode: number of engine cells behind the "
                         "router (0 = no fleet; implies the request-stream "
                         "driver)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="fleet only: pace prefill (1/cell/tick) so decode "
                         "ticks never starve behind a prefill burst; "
                         "default is interleaved (greedy prefill)")
    ap.add_argument("--router-policy", default="round_robin",
                    choices=("round_robin", "least_kv", "mode_affinity"),
                    help="fleet only: cell placement policy")
    ap.add_argument("--fault-plan", default="",
                    help="fleet only: JSON fault plan (serve/faults.py "
                         "FaultPlan) injected deterministically — cell "
                         "crashes, poisoned decode steps, failed handoffs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
    info = mesh_lib.join_from_env(args.device)
    if info is not None:
        args.device = str(info.device)
    with mesh_lib.rank0_prints(info):
        return _serve(args)


def _serve(args):
    if args.backend:
        import repro_torch.mp as mp
        mp.configure(backend=args.backend)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    if (not args.smoke and cfg.param_count() > 1e9
            and torch.device(args.device).type == "cpu"):
        raise SystemExit("full config on CPU: use --smoke")
    params = T.init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)

    if args.engines:
        return _run_fleet(cfg, params, args, rng)
    if args.scheduler:
        return _run_scheduler(cfg, params, args, rng)

    eng = ServeEngine(cfg, params, max_batch=args.requests,
                      max_seq=args.max_seq, policy=get_policy(args.policy),
                      device=args.device)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(2, 9)
                            ).astype(np.int32)
               for _ in range(args.requests)]
    outs = eng.generate(prompts, max_new=args.max_new)
    mesh_lib.check_same_on_every_rank(outs, "tokens")
    for i, o in enumerate(outs):
        print(f"req{i} ({len(prompts[i])} prompt toks): {o}")
    print(eng.decode_throughput_probe())
    return outs


def _build_stream(cfg, args, rng):
    """Poisson arrival trace shared by the scheduler and fleet drivers."""
    from repro_torch.serve.primitives import ScheduledRequest

    modes = ("M8", "M16", "M23") if args.mixed_modes else (None,)
    t = 0
    reqs = []
    for i in range(args.requests):
        t += int(rng.poisson(1.0 / max(args.arrival_rate, 1e-6)))
        reqs.append(ScheduledRequest(
            rid=i,
            prompt=rng.integers(0, cfg.vocab,
                                size=int(rng.integers(2, 17))
                                ).astype(np.int32),
            max_new=int(rng.integers(2, args.max_new + 1)),
            mode=modes[i % len(modes)],
            arrival=t))
    return reqs


def _run_scheduler(cfg, params, args, rng):
    """Request-stream driver: Poisson arrivals through the continuous
    scheduler, each request optionally carrying its own precision mode."""
    from repro_torch.serve.scheduler import ContinuousScheduler

    slots = min(args.requests, 8)
    eng = ServeEngine(cfg, params, max_batch=slots, max_seq=args.max_seq,
                      policy=get_policy(args.policy), device=args.device)
    block_size = args.kv_block_size
    n_blocks = args.kv_blocks or (
        1 + slots * 2 * max(1, -(-(args.max_seq) // block_size)))
    sched = ContinuousScheduler(eng, n_blocks=n_blocks,
                                block_size=block_size)
    done = sched.run(_build_stream(cfg, args, rng))
    mesh_lib.check_same_on_every_rank(
        {r.rid: list(r.out) for r in done}, "token streams")
    for r in sorted(done, key=lambda r: r.rid):
        qos = r.mode or "engine-default"
        print(f"req{r.rid} [{qos}] arrive@{r.arrival} "
              f"admit@{r.admitted_step} done@{r.done_step}: {r.out}")
    print(sched.stats())
    return sched


def _run_fleet(cfg, params, args, rng):
    """Fleet driver: the same Poisson stream routed over --engines cells
    (one shared ServeEngine, per-cell pools on the engine's device, paged-KV
    prefill->decode handoff) through the --router-policy placement
    policy."""
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.fleet import FleetRouter, make_fleet

    eng = ServeEngine(cfg, params, max_batch=4, max_seq=args.max_seq,
                      policy=get_policy(args.policy), device=args.device)
    block_size = args.kv_block_size
    n_blocks = args.kv_blocks or (
        1 + 8 * max(1, -(-(args.max_seq) // block_size)))
    cells = make_fleet(eng, args.engines, n_blocks=n_blocks,
                       block_size=block_size,
                       disaggregate=args.disaggregate)
    plan = None
    if args.fault_plan:
        with open(args.fault_plan) as f:
            plan = FaultPlan.from_json(f.read())
    router = FleetRouter(cells, policy=args.router_policy, fault_plan=plan)
    done = router.run(_build_stream(cfg, args, rng))
    mesh_lib.check_same_on_every_rank(
        {r.rid: list(r.out) for r in done}, "token streams")
    for r in sorted(done, key=lambda r: r.rid):
        qos = r.mode or "engine-default"
        extra = f" (downgraded from {r.downgraded_from})" \
            if r.downgraded_from else ""
        if r.escalated_from:
            extra += f" (escalated from {r.escalated_from})"
        if r.recoveries:
            extra += f" (recovered x{r.recoveries})"
        print(f"req{r.rid} [{qos}]{extra} arrive@{r.arrival} "
              f"cell{r.engine_id} done@{r.done_step}: {r.out}")
    if plan is not None:
        print("fault trace:", router.injector.trace)
    print(router.stats())
    return router


if __name__ == "__main__":
    try:
        main()
    finally:
        mesh_lib.shutdown()
