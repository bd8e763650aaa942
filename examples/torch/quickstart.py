"""Quickstart: the paper's 6 precision modes — plus a custom format — on a
single matmul, through the ``repro_torch.mp`` facade (the PyTorch port of
examples/quickstart.py).

    PYTHONPATH=src python examples/torch/quickstart.py               # the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu  # plain
"""
import argparse

import numpy as np
import torch

import repro_torch.mp as mp
from repro_torch.core.limbs import dd_from_f64
from repro_torch.kernels.ref import matmul_golden_f64


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = ap.parse_args().device

    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((256, 512)), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(rng.standard_normal((512, 256)), dtype=torch.float32,
                     device=dev)
    gold = matmul_golden_f64(a, b)
    gn = np.linalg.norm(gold)

    def rel_err(out):
        return np.linalg.norm(out.double().cpu().numpy() - gold) / gn

    print("format  bits  tensor-core-passes  rel-err (vs fp64)")
    for name in mp.available_formats():
        fmt = mp.get_format(name)
        out = mp.mp_matmul(a, b, fmt)
        print(f"{fmt.name:6s} {fmt.mantissa_bits:4d}  {fmt.n_products:18d}  "
              f"{rel_err(out):.3e}")

    # The mode table is OPEN: mint a paper-style custom width at run time.
    M30 = mp.register_format("M30", mantissa_bits=30, n_limbs=4, max_order=3)
    out = mp.mp_matmul(a, b, "M30")
    print(f"{M30.name:6s} {M30.mantissa_bits:4d}  {M30.n_products:18d}  "
          f"{rel_err(out):.3e}   <- registered at run time")

    # Mode 1 (AUTO): the controller inspects the operands.
    ints = torch.tensor(rng.integers(-99, 99, (256, 512)),
                        dtype=torch.float32, device=dev)
    print("\nAUTO on integer data:", mp.auto_report(ints, ints)
          ["selected_format"])
    print("AUTO on float data:  ", mp.auto_report(a, b)["selected_format"])
    out_auto = mp.mp_matmul(ints, ints.T.contiguous(), mp.AUTO)
    i64 = ints.double().cpu().numpy()
    exact = np.array_equal(out_auto.double().cpu().numpy(), i64 @ i64.T)
    print("AUTO integer product exact:", exact)

    # Scoped reconfiguration: backend + policy ride one explicit context.
    pol = mp.PrecisionPolicy({"moe_*": "M8", "lm_head": "M23", "*": "M16"})
    with mp.context(backend="ref", policy=pol):
        ctx = mp.current_context()
        print(f"\ncontext: backend={ctx.backend} "
              f"ffn={pol.mode('ffn').name} lm_head={pol.mode('lm_head').name}")

    # Modes 5/6 with true >24-bit operands (two-float DD representation)
    a64 = rng.standard_normal((64, 64))
    b64 = rng.standard_normal((64, 64))
    dd_out = mp.mp_matmul(dd_from_f64(a64, device=dev),
                          dd_from_f64(b64, device=dev), "M52")
    rel = np.linalg.norm(dd_out.double().cpu().numpy() - a64 @ b64) \
        / np.linalg.norm(a64 @ b64)
    print(f"\nM52 on 52-bit DD operands: rel-err {rel:.2e}")


if __name__ == "__main__":
    main()
