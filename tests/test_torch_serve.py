"""PyTorch port: the serving slice end to end against the JAX package, plus
import hygiene.

A JAX ``ServeEngine(SMOKE, params, prelimb_weights=False,
matmul_backend="pallas_interpret")`` and the port's
``ServeEngine(SMOKE, params_from_jax(params), device="cpu")`` (whose kernel
wrappers run their plain versions; decode on pre-limbed weights, the
default) serve the same weights.

Tolerance of the logits: under ``full_fp32`` (M23 everywhere) the two agree
to f32 summation order, 1e-5 of the logits' scale.  Under
``serve_default`` the projections run at M8, which rounds every activation
to bf16: a last-bit f32 difference between the frameworks (rsqrt, exp,
sin/cos, summation order) can move an activation across a bf16 rounding
boundary, a 2^-8 relative step on that element.  The logits are then held
at M8's own error budget (``rel_err_bound`` 2^-6) times their scale; only
the order of f32 sums and the last bit of those functions differ."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_mpfp as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import kernels
from repro_torch.configs import paper_mpfp as pconfigs
from repro_torch.core.formats import resolve
from repro_torch.core.policy import PrecisionPolicy as PPolicy
from repro_torch.models import transformer as PT
from repro_torch.serve.engine import ServeEngine
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [np.arange(1, 14, dtype=np.int32),
           np.asarray([5, 6, 7, 8, 9], np.int32)]
M8_BOUND = resolve("M8").rel_err_bound


@pytest.fixture(scope="module")
def jax_params():
    return JT.init_params(jconfigs.SMOKE, jax.random.PRNGKey(0))


def _engines(jax_params, policy_name):
    je = JEngine(jconfigs.SMOKE, jax_params, max_batch=2, max_seq=48,
                 prelimb_weights=False, matmul_backend="pallas_interpret",
                 policy=getattr(JPolicy, policy_name)())
    np_params = jax.tree_util.tree_map(np.asarray, jax_params)
    pe = ServeEngine(pconfigs.SMOKE, params_from_jax(np_params), max_batch=2,
                     max_seq=48, device="cpu",
                     policy=getattr(PPolicy, policy_name)())
    return je, pe


def _prefill_both(je, pe):
    toks = pe.pad_prompts(PROMPTS)
    jc = JT.make_cache(jconfigs.SMOKE, 2, 48, dtype=jnp.float32)
    jl, jc = je._prefill(je.params, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jc)
    pl, pc = pe.prefill(toks, pe.make_cache())
    return np.asarray(jl), jc, pl.numpy(), pc


@pytest.mark.parametrize("policy_name,rel_tol", [
    ("full_fp32", 1e-5), ("serve_default", M8_BOUND)])
def test_prefill_and_teacher_forced_decode_logits_match_jax(
        jax_params, policy_name, rel_tol):
    kernels.reset_launch_counts()
    je, pe = _engines(jax_params, policy_name)
    jl, jc, pl, pc = _prefill_both(je, pe)
    scale = np.abs(jl).max()
    np.testing.assert_allclose(pl, jl, rtol=0, atol=rel_tol * scale)
    cur = np.argmax(jl[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(4):  # feed both engines the JAX token stream
        jl, jc = je._decode(je.params, jc, jnp.asarray(cur))
        pl, pc = pe.decode(pc, torch.as_tensor(cur, dtype=torch.long))
        jl, pl = np.asarray(jl), pl.numpy()
        np.testing.assert_allclose(pl, jl, rtol=0,
                                   atol=rel_tol * np.abs(jl).max())
        cur = np.argmax(jl[:, -1], -1)[:, None].astype(np.int32)
    # every kernel of the static path (decode on pre-limbed weights); the
    # paged and mixed-lane kernels serve the continuous scheduler only, the
    # both-prelimbed kernel two-float (DD) operands only, and the partials
    # epilogue the sharded backend only
    calls = kernels.plain_call_counts()
    off_path = ("mp_paged_attention", "mp_mixed_prelimbed_matmul",
                "mp_mixed_paged_attention", "mp_both_prelimbed_matmul",
                "mp_fused_matmul_partials")
    assert all(calls[name] > 0 for name in kernels.KERNELS
               if name not in off_path), calls
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_generate_streams_equal_where_margin_exceeds_tolerance(jax_params):
    je, pe = _engines(jax_params, "serve_default")
    max_new = 6
    j_out = je.generate(PROMPTS, max_new=max_new)
    p_out = pe.generate(PROMPTS, max_new=max_new)
    # top-2 margins along the JAX stream (teacher-forced)
    jl, jc, _, _ = _prefill_both(je, pe)
    margins, logits = [], jl[:, -1]
    for step in range(max_new):
        top2 = np.sort(logits, -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = np.asarray([o[step] for o in j_out] + [0] * (2 - len(j_out)),
                         np.int32)[:, None]
        out, jc = je._decode(je.params, jc, jnp.asarray(tok))
        logits = np.asarray(out)[:, -1]
    tol = M8_BOUND * np.abs(jl).max()
    for i in range(len(PROMPTS)):
        for step in range(max_new):
            if margins[step][i] <= tol:
                break  # a near-tie: the streams may part from here on
            assert p_out[i][step] == j_out[i][step], (i, step)


def test_policy_json_from_jax_drives_the_port_engine(jax_params):
    _, pe = _engines(jax_params, "serve_default")
    pol = pe.set_policy(JPolicy({"*": "M23", "lm_head": "M36"}).to_json())
    assert pol.mode("qkv").name == "M23" and pol.mode("lm_head").name == "M36"
    assert len(pe.generate(PROMPTS[:1], max_new=2)[0]) == 2


def test_engine_options():
    params = PT.init_params(pconfigs.SMOKE, seed=0)
    # pre-limbed decode weights (the default) cannot move a token: the
    # pre-limbed matmul sums the fused kernel's limb products in its order
    prompts = [np.arange(1, 12), np.asarray([7, 3, 9])]
    raw = ServeEngine(pconfigs.SMOKE, params, prelimb_weights=False,
                      device="cpu")
    limbed = ServeEngine(pconfigs.SMOKE, params, device="cpu")
    assert limbed.prelimb_weights and limbed.cache_stats()[
        "prelimb_cache_misses"] == 1
    assert limbed.generate(prompts, max_new=4) == raw.generate(prompts,
                                                               max_new=4)
    if torch.cuda.is_available():
        assert ServeEngine(pconfigs.SMOKE, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(pconfigs.SMOKE, params)  # no silent CPU fallback
    eng = ServeEngine(pconfigs.SMOKE, params, device="cpu", max_seq=16)
    with pytest.raises(ValueError):
        eng.generate([np.arange(1, 12)], max_new=8)
    probe = eng.decode_throughput_probe(steps=2)
    assert probe["tokens_per_s"] > 0


def test_init_params_is_seeded():
    a = PT.init_params(pconfigs.SMOKE, seed=3)
    b = PT.init_params(pconfigs.SMOKE, seed=3)
    c = PT.init_params(pconfigs.SMOKE, seed=4)
    assert torch.equal(a["layers"][1]["mlp"]["w_up"],
                       b["layers"][1]["mlp"]["w_up"])
    assert not torch.equal(a["lm_head"]["w"], c["lm_head"]["w"])
    assert a["embed"]["table"].shape == (pconfigs.SMOKE.padded_vocab, 64)


def test_import_hygiene_no_jax_no_repro():
    """Every module of repro_torch, and chip_smoke, import without jax or
    the JAX package."""
    code = (
        "import importlib, pkgutil, sys, json\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(json.dumps({'mods': mods, 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert {"repro_torch.serve.engine", "repro_torch.kernels.build",
            "repro_torch.weights", "repro_torch.serve.kv_cache",
            "repro_torch.serve.primitives", "repro_torch.core.lanes",
            "repro_torch.serve.scheduler", "repro_torch.train.trainer",
            "repro_torch.optim.adamw", "repro_torch.checkpoint.checkpoint",
            "repro_torch.launch.train"} <= set(res["mods"])


def test_ptxas_summary_compares_entries_across_versions():
    """The register report keys an entry by its mangled name without the
    anonymous-namespace tag nvcc derives from the file's contents, so the
    same kernel of two versions of a source meets under one key."""
    from repro_torch.kernels import build

    def log(tag, regs, spill):
        return (f"ptxas info    : Compiling entry function '_ZN45_GLOBAL__N"
                f"__{tag}_12_mp_matmul_cu_3f25466e23prelimbed_matmul_kernel"
                f"ILi1ELi1ELi4ELi4ELb0EEEvNS_13PrelimbedArgsE' for 'sm_90a'\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers\n")

    old, new = build.ptxas_summary(log("e0cb4247", 61, 0)), \
        build.ptxas_summary(log("73b160df", 64, 12))
    assert list(old) == list(new) == [
        "_ZN45prelimbed_matmul_kernelILi1ELi1ELi4ELi4ELb0EEEvNS_13"
        "PrelimbedArgsE"]
    assert list(old.values()) == [[61, 0, 0]]
    assert list(new.values()) == [[64, 12, 12]]


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_request_fields_equal_jax():
    """``repro_torch.serve.engine.Request`` is the JAX package's
    ``serve.engine.Request``: the same fields in the same order, with the
    same defaults, and an instance of each holds the same values."""
    import dataclasses

    from repro.serve.engine import Request as JRequest
    from repro_torch.serve.engine import Request

    def spec(cls):
        return [(f.name, f.default,
                 f.default_factory() if f.default_factory
                 is not dataclasses.MISSING else None)
                for f in dataclasses.fields(cls)]
    assert spec(Request) == spec(JRequest)
    prompt = np.arange(1, 6, dtype=np.int32)
    mine, theirs = Request(7, prompt, 3), JRequest(7, prompt, 3)
    mine.out.append(11)
    theirs.out.append(11)
    a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) if k == "prompt" else a[k] == b[k]
               for k in a)
