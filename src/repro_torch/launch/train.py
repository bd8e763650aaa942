"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 50 \\
        --policy train_default --device cpu

Across ranks under torchrun the launcher lays the state out as the JAX
launcher does, by ``launch/specs.make_rules`` on a (data = W, model = 1)
mesh ("the mesh, sharding rules and step function are identical to the
dry-run's"): for a non-MoE family whose batch divides the ranks that is
the FSDP layout (``dist/fsdp.py``): each rank holds its blocks of the
parameters and moments, trains on its rows of each batch, and rank 0
writes the one checkpoint directory (the global arrays).  Each matmul then
runs on the rank's rows (``--backend sharded`` would K-shard them again
over the ranks: the trainer refuses it under the layout).  Where the
layout does not apply (``specs.train_layout``, which on this mesh picks
FSDP or nothing: the MoE family, a batch that does not divide the
ranks) every rank holds the whole state, takes the same steps on the same batches under
``--backend`` (``sharded``: K-sharded matmuls) and checkpoints into its own
``rank<r>`` directory.  Rank 0 prints; every rank checks that its losses
equal rank 0's:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --smoke --steps 4 --device cpu

Runs on the card unless ``--device cpu`` is given (every kernel wrapper
then runs its plain version).  ``--arch`` takes every id of
``configs/registry.py`` (``--smoke`` for its CI-sized config); the vision
and audio families train on the pipeline's stub patch and frame
embeddings, the MoE family with its aux and z-losses:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --smoke --steps 2 --device cpu
"""
import argparse
import os

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.core.policy import POLICIES, get_policy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-mpfp-100m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--policy", default="train_default",
                    choices=sorted(POLICIES))
    ap.add_argument("--backend", default="",
                    help="mp_matmul dispatch backend (cuda/ref/sharded); "
                         "'' = the context's default; 'sharded' only "
                         "where the FSDP layout does not apply")
    ap.add_argument("--ckpt-dir", default="",
                    help="default: build/ckpt/<arch> in the checkout")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    info = mesh_lib.join_from_env(args.device)
    if info is not None:
        args.device = str(info.device)
    with mesh_lib.rank0_prints(info):
        return _train(args, info)


def _train(args, info=None):
    cfg = get_config(args.arch, smoke=args.smoke)
    if not args.smoke and cfg.param_count() > 1e9 and args.device == "cpu":
        raise SystemExit(f"{args.arch} full config is {cfg.param_count():,} "
                         f"params — use --smoke on the CPU")
    ckpt_dir = args.ckpt_dir or os.path.join(ROOT, "build", "ckpt",
                                             args.arch)
    layout = None
    if info is not None:
        mesh = mesh_lib.make_debug_mesh(data=info.world_size, model=1)
        cell = ShapeCell("launch", args.seq, args.batch, "train")
        layout = specs_lib.train_layout(
            cfg, cell, specs_lib.make_rules(mesh, cell, cfg))
        if layout is not None:
            print(f"FSDP layout over {info.world_size} ranks, batch axes "
                  f"{layout.rules.batch_axes}")
        else:
            ckpt_dir = os.path.join(ckpt_dir, f"rank{info.rank}")

    pipe = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq + 1, global_batch=args.batch,
        frontend=cfg.frontend, d_model=cfg.d_model,
        n_patches=cfg.n_patches))
    tcfg = trainer_lib.TrainerConfig(
        opt=adamw.AdamWConfig(moment_dtype=args.moment_dtype),
        total_steps=args.steps, warmup=max(2, args.steps // 20),
        ckpt_dir=ckpt_dir, ckpt_every=max(10, args.steps // 5),
        matmul_backend=args.backend)
    trainer = trainer_lib.Trainer(cfg, tcfg, policy=get_policy(args.policy),
                                  device=args.device, layout=layout)
    state, history = trainer.run(pipe, num_steps=args.steps, log_every=10)
    mesh_lib.check_same_on_every_rank(history, "losses")
    if history:
        print(f"done: loss {history[0]:.4f} -> {history[-1]:.4f}")
    else:
        print(f"done: nothing to run (resumed at step {args.steps})")
    return state, history


if __name__ == "__main__":
    try:
        main()
    finally:
        mesh_lib.shutdown()
