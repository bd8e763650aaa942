"""PyTorch port: format registry, limb cascade, policy and context parity with
the JAX package (formats and policy JSON equal, ``decompose`` bitwise)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import limbs as jlimbs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro_torch.core import context as pcontext
from repro_torch.core import formats as pformats
from repro_torch.core import limbs as plimbs
from repro_torch.core.policy import PrecisionPolicy as PPolicy

OP_CLASSES = ("qkv", "attn_logits", "attn_out", "attn_qk", "attn_pv", "ffn",
              "lm_head", "moe_router", "moe_expert", "ssm", "anything")


def _spread(seed, shape=(257, 301)):
    """f32 values spanning +-20 e-folds of magnitude, both signs."""
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(-20, 20, shape))
    return (rng.standard_normal(shape) * mag).astype(np.float32)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_builtin_table_equals_jax():
    assert pformats.builtin_formats() == jformats.builtin_formats()
    for name in jformats.builtin_formats():
        j, p = jformats.get_format(name), pformats.get_format(name)
        assert (p.name, p.mantissa_bits, p.n_limbs, p.max_order,
                p.rel_err_bound, p.mode_bits) == (
            j.name, j.mantissa_bits, j.n_limbs, j.max_order,
            j.rel_err_bound, j.mode_bits)
        assert p.products == j.products
        assert (p.n_products, p.n_orders) == (j.n_products, j.n_orders)
        assert pformats.format_def(p) == jformats.format_def(j)


@pytest.mark.parametrize("spelling", ["M16", 2, "M52", 5])
def test_resolve_spellings_equal_jax(spelling):
    assert pformats.resolve(spelling).name == jformats.resolve(spelling).name
    mode = pformats.PrecisionMode(jformats.resolve(spelling).mode)
    assert pformats.resolve(mode).name == jformats.resolve(spelling).name


def test_register_format_semantics_equal_jax():
    name = "M28TP"
    kw = dict(mantissa_bits=28, n_limbs=4, max_order=3)
    try:
        j, p = (lib.register_format(name, **kw) for lib in (jformats, pformats))
        assert (p.n_limbs, p.max_order, p.rel_err_bound, p.products) == (
            j.n_limbs, j.max_order, j.rel_err_bound, j.products)
        assert pformats.register_format(name, **kw) is p  # idempotent
        for lib in (jformats, pformats):
            with pytest.raises(ValueError):
                lib.register_format(name, mantissa_bits=28, n_limbs=4,
                                    max_order=2)
            with pytest.raises(ValueError):
                lib.register_format("AUTO", mantissa_bits=8, n_limbs=1)
            with pytest.raises(ValueError):
                lib.resolve("auto")
            assert lib.is_auto(0) and lib.is_auto("Auto")
    finally:
        jformats.unregister_format(name)
        pformats.unregister_format(name)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_policy_json_round_trip_across_packages(direction):
    """A policy written by either package loads in the other — custom
    formats embedded — and resolves every op class identically."""
    name = "M20RT" if direction == "jax_to_torch" else "M20TR"
    src, dst = (JPolicy, PPolicy) if direction == "jax_to_torch" \
        else (PPolicy, JPolicy)
    src_fmt = jformats if src is JPolicy else pformats
    try:
        src_fmt.register_format(name, mantissa_bits=20, n_limbs=3,
                                max_order=1)
        pol = src({"qkv": "M8", "ffn*": name, "attn_logits": "M23",
                   "attn_pv": {"fwd": "M16", "wgrad": "M23"}},
                  bwd_dgrad="M23")
        loaded = dst.from_json(pol.to_json())
        assert json.loads(loaded.to_json()) == json.loads(pol.to_json())
        for op in OP_CLASSES:
            assert loaded.mode(op).name == pol.mode(op).name, op
            for acc in ("dgrad", "wgrad"):
                a, b = getattr(loaded, acc)(op), getattr(pol, acc)(op)
                assert (a and a.name) == (b and b.name), (op, acc)
    finally:
        for lib in (jformats, pformats):
            if name in lib.available_formats():
                lib.unregister_format(name)


@pytest.mark.parametrize("recipe", ["serve_default", "full_fp32"])
def test_policy_recipes_resolve_equal(recipe):
    j, p = getattr(JPolicy, recipe)(), getattr(PPolicy, recipe)()
    for op in OP_CLASSES:
        assert p.mode(op).name == j.mode(op).name, op


@pytest.mark.parametrize("n_limbs", range(1, 8))
def test_decompose_bitwise_equals_jax(n_limbs):
    x = _spread(n_limbs)
    j = jlimbs.decompose(jnp.asarray(x), n_limbs)
    p = plimbs.decompose(torch.from_numpy(x), n_limbs)
    assert p.dtype == torch.bfloat16 and tuple(p.shape) == j.shape
    np.testing.assert_array_equal(_bits(p), _bits(j))


def test_reconstruct_and_neumaier_bitwise_equal_jax():
    x = _spread(11)
    jl = jlimbs.decompose(jnp.asarray(x), 3)
    pl = plimbs.decompose(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(plimbs.reconstruct(pl).numpy(),
                                  np.asarray(jlimbs.reconstruct(jl)))
    terms = [_spread(20 + i, (64, 33)) * 2.0 ** (-8 * i) for i in range(5)]
    j = jlimbs.neumaier_sum([jnp.asarray(t) for t in terms])
    p = plimbs.neumaier_sum([torch.from_numpy(t) for t in terms])
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_context_backend_default_scope_and_validation():
    pcontext.reset_context()
    try:
        assert pcontext.current_context().backend == "cuda"
        with pcontext.context(backend="ref") as ctx:
            assert ctx.backend == "ref"
            assert pcontext.current_context().backend == "ref"
        assert pcontext.current_context().backend == "cuda"
        with pytest.raises(ValueError):
            pcontext.configure(backend="pallas")
        pol = PPolicy.full_fp32()
        pcontext.configure(policy=pol)
        assert pcontext.current_context().policy == pol
    finally:
        pcontext.reset_context()
