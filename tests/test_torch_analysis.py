"""The port's roofline and work accounting (``repro_torch.analysis``)
against the JAX package's (``repro.analysis.roofline``,
``repro.analysis.hlo_parser``): ``model_flops`` equal for every registry id
and phase, the H100 constants, the dispatch-level counter against the loop-
aware HLO parser on JAX's unrolled compile of the same SMOKE forward, and
the counts of a step on the CPU (``ref``, real tensors) equal to the same
step's meta dry run, exactly; ``flops_factor``, ``naive_multipass_ref`` and
the trainer's serving steps."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import repro_torch.mp as mp
from repro.analysis import hlo_parser
from repro.analysis import roofline as jrl
from repro.configs.registry import ARCH_IDS as JARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as JT
from repro_torch.analysis import accounting
from repro_torch.analysis import roofline as rl
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from torch_parity import assert_matmul_close


def test_h100_constants():
    """chip_smoke.py's bounds (PERF.md section 6) use these numbers."""
    sxm = rl.hardware(rl.H100_SXM)
    assert (sxm.peak_bf16, sxm.hbm_bw, sxm.peak_f32, sxm.link_bw) == \
        (989e12, 3.35e12, 67e12, 450e9)
    pcie = rl.hardware(rl.H100_PCIE)
    assert (pcie.peak_bf16, pcie.hbm_bw) == (756e12, 2.0e12)
    with pytest.raises(ValueError, match="no roofline constants"):
        rl.hardware("NVIDIA GeForce RTX 4090")
    other = rl.hardware("NVIDIA GeForce RTX 4090", peak_bf16=1.0, hbm_bw=2.0,
                        peak_f32=3.0, link_bw=4.0)
    assert other.name == "NVIDIA GeForce RTX 4090" and other.hbm_bw == 2.0
    # a bound is the larger of the two times, named by its side
    assert rl.bound_s(989e12, 1.0, sxm) == (1.0, "operations")
    assert rl.bound_s(1.0, 3.35e12, sxm) == (1.0, "bytes")
    assert rl.bound_s(67e12, 1.0, sxm, peak=sxm.peak_f32)[0] == 1.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_is_jax(arch):
    assert arch in JARCH_IDS
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in SHAPES.values():
        for phase in ("train", "prefill", "decode"):
            assert rl.model_flops(cfg, phase, shape.seq_len,
                                  shape.global_batch) == \
                jrl.model_flops(jcfg, phase, shape.seq_len,
                                shape.global_batch)


def test_roofline_terms():
    r = rl.Roofline(flops_per_chip=989e12, bytes_per_chip=6.7e12,
                    collective_bytes_per_chip=450e9,
                    model_flops_global=2 * 989e12, n_chips=4)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 2.0, 1.0)
    assert r.dominant == "memory" and r.bound_s == 2.0
    assert r.useful_flops_fraction == 0.5
    assert r.mfu_bound == pytest.approx(0.25)
    d = r.to_dict()
    assert d["hardware"] == rl.H100_SXM and d["bound_s"] == 2.0
    j = jrl.Roofline(flops_per_chip=1.0, bytes_per_chip=1.0,
                     collective_bytes_per_chip=1.0)
    assert set(d) - {"hardware"} == set(j.to_dict())


def _jax_unrolled_flops():
    cfg = dataclasses.replace(jget_config("paper-mpfp-100m", smoke=True),
                              scan_layers=False, remat=False)
    params = jax.eval_shape(lambda: JT.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    tok = jax.ShapeDtypeStruct((2, 32), jnp.int32)

    def f(p, t):
        logits, _, _ = JT.forward(p, {"tokens": t}, cfg,
                                  JPolicy.train_default())
        return logits.sum()

    return hlo_parser.analyze_hlo(jax.jit(f).lower(params, tok).compile()
                                  .as_text()).flops


def test_counter_against_hlo_parser():
    """The SMOKE forward (2 x 32 tokens, train_default) counted at
    dispatch under ``ref`` on the CPU against ``hlo_parser`` of JAX's
    unrolled compile.  Both count every kept limb product of every matmul;
    they differ only in the causal attention: JAX's forward contracts the
    whole S x T rectangle, the counter the pairs a row sees.  So the
    counter plus that difference is JAX's count exactly, and the ratio is
    the one that difference implies (inside test_hlo_parser's (0.5, 1.05])."""
    cfg = get_config("paper-mpfp-100m", smoke=True)
    params = T.init_params(cfg)
    tok = torch.randint(0, cfg.vocab, (2, 32),
                        generator=torch.Generator().manual_seed(0))
    with mp.context(backend="ref"), accounting.count_work() as w:
        T.forward(params, {"tokens": tok}, cfg,
                  PrecisionPolicy.train_default())
    rect = 0
    for c in w.calls:
        if c.kind == "attention":     # (B * H, S, Dh, T): causal, offset 0
            seen = accounting.visible_pairs(c.M, c.N, True)
            rect += c.flops * (c.M * c.N) // seen - c.flops
    jflops = _jax_unrolled_flops()
    assert w.flops + rect == jflops
    ratio = w.flops / jflops
    assert ratio == pytest.approx(w.flops / (w.flops + rect), abs=0)
    assert 0.5 < ratio <= 1.05


def test_visible_pairs():
    for S, T_, off in ((5, 5, 0), (3, 8, 5), (4, 4, 2), (7, 3, 0),
                       (1, 9, 8), (6, 6, 9)):
        want = sum(min(T_, off + s + 1) for s in range(S))
        assert accounting.visible_pairs(S, T_, True, off) == want
    assert accounting.visible_pairs(4, 6, False) == 24


def _materialize(obj):
    """Zeros on the CPU in place of every meta tensor of a tree."""
    if isinstance(obj, torch.Tensor):
        return torch.zeros(obj.shape, dtype=obj.dtype)
    if isinstance(obj, dict):
        return {k: _materialize(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_materialize(v) for v in obj]
    if isinstance(obj, tuple):
        vals = [_materialize(v) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _materialize(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


@pytest.mark.parametrize("arch,phase", [
    ("paper-mpfp-100m", "train"), ("paper-mpfp-100m", "prefill"),
    ("paper-mpfp-100m", "decode"), ("deepseek-v2-lite-16b", "prefill"),
    ("mamba2-130m", "train"), ("hubert-xlarge", "prefill")])
def test_cpu_counts_equal_the_meta_dry_run(arch, phase):
    """One step of a SMOKE config at 2 x 32 tokens: counted on meta
    tensors (the dry run's ``build_cell``) and on CPU tensors under ``ref``
    (the same step on zeros of the same shapes): the same integers."""
    cfg = get_config(arch, smoke=True)
    cell = specs.build_cell(arch, cfg, ShapeCell("cpu", 32, 2, phase))
    with accounting.count_work() as meta:
        out = cell.fn(*cell.args)
    assert all(t.is_meta for t in _tensors(out))
    args = _materialize(cell.args)
    with mp.context(backend="ref"), accounting.count_work() as cpu:
        cell.fn(*args)
    assert meta.summary() == cpu.summary()
    assert meta.flops > 0 and meta.bytes > 0


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def test_flops_factor_is_jax():
    from repro.core import formats as jformats
    from repro_torch.core import formats

    for name in formats.builtin_formats():
        assert formats.get_format(name).flops_factor == \
            jformats.get_format(name).flops_factor
    formats.register_format("X26FF", mantissa_bits=26, n_limbs=4,
                            max_order=2)
    jformats.register_format("X26FF", mantissa_bits=26, n_limbs=4,
                             max_order=2)
    try:
        got = formats.get_format("X26FF").flops_factor
        assert got == jformats.get_format("X26FF").flops_factor == 6.0
    finally:
        formats.unregister_format("X26FF")
        jformats.unregister_format("X26FF")


@pytest.mark.parametrize("mode", ["M8", "M16", "M23", "M36"])
def test_naive_multipass_ref_is_jax(mode):
    """All n_limbs^2 limb products, no order cut, a left-to-right f32 sum
    of bf16 limbs upcast to f32 (the paper's schoolbook baseline)."""
    import numpy as np

    from repro.kernels import ref as jref
    from repro_torch.kernels import ref

    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((33, 96)), rng.standard_normal((96, 40))
    got = ref.naive_multipass_ref(torch.tensor(a, dtype=torch.float32),
                                  torch.tensor(b, dtype=torch.float32), mode)
    want = np.asarray(jref.naive_multipass_ref(jnp.asarray(a, jnp.float32),
                                               jnp.asarray(b, jnp.float32),
                                               mode))
    assert got.dtype == torch.float32
    # the two sum the same exact bf16 x bf16 products in their own orders:
    # the port's parity tolerance, rtol 2e-6 (tests/torch_parity.py)
    assert_matmul_close(got, want)


def test_trainer_has_the_serving_steps():
    """``repro_torch.train.trainer`` mirrors ``repro.train.trainer``: the
    prefill and serve steps are the engine's own."""
    from repro.train import trainer as jtrainer
    from repro_torch.serve import engine
    from repro_torch.train import trainer

    for name in ("make_prefill_step", "make_serve_step", "make_train_step"):
        assert hasattr(jtrainer, name)
    assert trainer.make_prefill_step is engine.make_prefill_step
    assert trainer.make_serve_step is engine.make_serve_step
