"""End-to-end training driver: train a ~100M-param LM with the run-time
reconfigurable multiplier, checkpointing and fault tolerance enabled (the
PyTorch port of examples/train_lm.py).

    PYTHONPATH=src python examples/torch/train_lm.py --steps 200 \\
        --policy train_default                 # full width, on the card
    PYTHONPATH=src python examples/torch/train_lm.py --smoke --device cpu

Defaults to the full 12L x 768 (~100M) model for a few hundred steps on
the card; --smoke runs the reduced config.  The synthetic bigram stream is
learnable, so the loss curve is real.  Checkpoints go to
build/train_lm_ckpt in the checkout unless --ckpt-dir says otherwise.
"""
import argparse
import os

from repro_torch.configs.registry import get_config
from repro_torch.core.policy import get_policy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--policy", default="train_default",
                    help="train_default|train_fast|full_fp32|auto")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "train_lm_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config("paper-mpfp-100m", smoke=args.smoke)
    # the model sees seq_len - 1 tokens; 32 keeps the smoke run's chunks
    # whole, as the JAX example does
    seq = 32 if args.smoke else args.seq
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                  global_batch=args.batch))
    tcfg = trainer_lib.TrainerConfig(
        opt=adamw.AdamWConfig(lr=3e-4 if not args.smoke else 3e-3),
        total_steps=args.steps, warmup=max(2, args.steps // 20),
        ckpt_dir=args.ckpt_dir, ckpt_every=max(10, args.steps // 5),
    )
    trainer = trainer_lib.Trainer(cfg, tcfg, policy=get_policy(args.policy),
                                  device=args.device)
    print(f"training {cfg.name} ({cfg.param_count():,} params) "
          f"policy={args.policy} steps={args.steps} device={args.device}")
    state, history = trainer.run(pipe, num_steps=args.steps, log_every=10)
    print(f"loss: {history[0]:.4f} -> {history[-1]:.4f}  "
          f"(rollbacks={trainer.rollbacks}, "
          f"stragglers={trainer.straggler_events})")


if __name__ == "__main__":
    main()
