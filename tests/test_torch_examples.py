"""Each PyTorch example (``examples/torch/*.py``, counterparts of
``examples/*.py``) runs once at SMOKE size on the CPU (``--device cpu``:
every kernel wrapper runs its plain version) in a subprocess, one thread."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNS = {
    "quickstart": ([], ("M52", "M30", "AUTO integer product exact: True",
                        "M52 on 52-bit DD operands")),
    "serve_demo": ([], ("policy=mode1 (AUTO)", "after set_policy",
                        "continuous scheduler", "fleet router (2 cells")),
    "train_lm": (["--smoke", "--steps", "3"], ("training paper-mpfp-smoke",
                                               "loss: ")),
    "precision_sweep": (["--steps", "1", "--batch", "2"],
                        ("mode2_M8", "mode3_M16", "mode4_M23",
                         "mode1_AUTO")),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, expect = RUNS[name]
    if name == "train_lm":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch",
                                      f"{name}.py"), *args,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    for text in expect:
        assert text in out.stdout, (text, out.stdout[-2000:])
    assert "jax" not in open(os.path.join(ROOT, "examples", "torch",
                                          f"{name}.py")).read()
