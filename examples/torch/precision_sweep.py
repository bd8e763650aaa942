"""Precision-mode ablation: train the same model under every mode policy and
print the loss-vs-cost frontier (the paper's accuracy/power trade-off; the
PyTorch port of examples/precision_sweep.py).

    PYTHONPATH=src python examples/torch/precision_sweep.py --steps 30
    PYTHONPATH=src python examples/torch/precision_sweep.py --steps 1 \\
        --batch 2 --device cpu
"""
import argparse
import time

import repro_torch.mp as mp
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config("paper-mpfp-100m", smoke=True)
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=33,
                                  global_batch=args.batch))

    policies = {
        "mode2_M8": PrecisionPolicy.train_fast(),
        "mode3_M16": PrecisionPolicy.train_default(),
        "mode4_M23": PrecisionPolicy.full_fp32(),
        "mode1_AUTO": PrecisionPolicy.auto(),
    }
    print(f"{'policy':12s} {'final loss':>10s} {'s/step':>8s} "
          f"{'fwd passes':>10s}")
    for name, pol in policies.items():
        tcfg = trainer_lib.TrainerConfig(
            opt=adamw.AdamWConfig(lr=3e-3), total_steps=args.steps, warmup=2)
        tr = trainer_lib.Trainer(cfg, tcfg, policy=pol, device=args.device)
        t0 = time.perf_counter()
        _, hist = tr.run(pipe, num_steps=args.steps, log_every=0)
        dt = (time.perf_counter() - t0) / args.steps
        ffn = pol.mode("ffn")
        passes = ("dyn" if mp.is_auto(ffn)
                  else str(mp.resolve(ffn).n_products))
        print(f"{name:12s} {hist[-1]:10.4f} {dt:8.2f} {passes:>10s}")


if __name__ == "__main__":
    main()
