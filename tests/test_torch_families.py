"""PyTorch port: the modules of the other model families (MLA, MoE, the
Mamba2 SSD mixer, the hybrid's LoRA-patched shared attention, layer_norm,
interleaved rope, the multimodal stubs) held against the JAX package on the
same numpy inputs, weights carried across as numpy arrays.

The JAX functions run on their default ``ref`` backend (the oracle the JAX
suite holds its kernels against on the CPU); the port's kernel wrappers run
their plain versions.  Tolerances are ``tests/torch_parity.py``'s: a single
limb matmul at rtol 2e-6, attention at 2e-5; a module of several
contractions under ``full_fp32`` at 1e-5 of its output's scale (f32
summation order only), and under ``serve_default`` at M8's error bound
(``rel_err_bound``) of the scale, where limbs round activations to bf16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_236b as j_v2
from repro.configs import deepseek_v2_lite_16b as j_lite
from repro.configs import hubert_xlarge as j_hubert
from repro.configs import llava_next_34b as j_llava
from repro.configs import mamba2_130m as j_mamba
from repro.configs import registry as jregistry
from repro.configs import zamba2_2_7b as j_zamba
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import multimodal as jmm
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro_torch.configs import hubert_xlarge as p_hubert
from repro_torch.configs import llava_next_34b as p_llava
from repro_torch.configs import zamba2_2_7b as p_zamba
from repro_torch.configs import registry
from repro_torch.core.formats import resolve
from repro_torch.core.mpmatmul import mp_matmul
from repro_torch.core.policy import PrecisionPolicy as PPolicy
from repro_torch.models import layers as players
from repro_torch.models import mla as pmla
from repro_torch.models import moe as pmoe
from repro_torch.models import multimodal as pmm
from repro_torch.models import ssm as pssm
from repro_torch.models import transformer as PT
from repro_torch.weights import params_from_jax
from torch_parity import assert_matmul_close

M8_BOUND = resolve("M8").rel_err_bound
M23_BOUND = resolve("M23").rel_err_bound
POLICIES = {"full_fp32": 1e-5, "serve_default": M8_BOUND}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, copy=True))


def _close(out, ref, rel):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------- layers
def test_layer_norm_and_interleaved_rope_match_jax():
    x = _x(0, 3, 7, 64)
    w, b = _x(1, 64), _x(2, 64)
    _close(players.layer_norm(torch.as_tensor(x), torch.as_tensor(w),
                              torch.as_tensor(b)),
           jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b)), 2e-6)
    q = _x(3, 2, 9, 4, 8)
    pos = np.broadcast_to(np.arange(5, 14)[None], (2, 9)).astype(np.int32)
    _close(players.apply_rope_interleaved(torch.as_tensor(q),
                                          torch.as_tensor(pos), 500.0),
           jlayers.apply_rope_interleaved(jnp.asarray(q), jnp.asarray(pos),
                                          500.0), 2e-6)


def test_multimodal_stubs_bitwise_and_notes():
    a = jmm.vision_patch_embeds_stub(np.random.default_rng(4), 2,
                                     j_llava.SMOKE)
    b = pmm.vision_patch_embeds_stub(np.random.default_rng(4), 2,
                                     p_llava.SMOKE)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    a = jmm.audio_frame_embeds_stub(np.random.default_rng(5), 2, 11,
                                    j_hubert.SMOKE)
    b = pmm.audio_frame_embeds_stub(np.random.default_rng(5), 2, 11,
                                    p_hubert.SMOKE)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    for arch in registry.ARCH_IDS:
        assert pmm.frontend_notes(registry.get_config(arch)) == \
            jmm.frontend_notes(jregistry.get_config(arch))


# ---------------------------------------------------------------------- MLA
MLA_DIMS = {"lite": (j_lite.SMOKE.mla, registry.get_config(
    "deepseek-v2-lite-16b", smoke=True).mla),
            "q_lora": (j_v2.SMOKE.mla, registry.get_config(
                "deepseek-v2-236b", smoke=True).mla)}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("which", sorted(MLA_DIMS))
def test_mla_prefill_and_absorbed_decode_match_jax(which, policy):
    jd, pd = MLA_DIMS[which]
    rel = POLICIES[policy]
    jp = jmla.init_mla_params(jax.random.PRNGKey(3), jd)
    pp = _t(_np(jp))
    jpol, ppol = getattr(JPolicy, policy)(), getattr(PPolicy, policy)()
    B, S = 2, 12
    x = _x(6, B, S + 1, jd.d_model)
    # prefill without a cache, then with one, then one absorbed decode step
    jo, _ = jmla.mla_forward(jp, jnp.asarray(x[:, :S]), jd, jpol)
    with torch.no_grad():
        po, _ = pmla.mla_forward(pp, torch.as_tensor(x[:, :S]), pd, ppol)
    _close(po, jo, rel)
    jc = jmla.make_mla_cache(B, 16, jd, jnp.float32)
    pc = pmla.make_mla_cache(B, 16, pd, torch.float32)
    jo, jc = jmla.mla_forward(jp, jnp.asarray(x[:, :S]), jd, jpol, cache=jc)
    with torch.no_grad():
        po, pc = pmla.mla_forward(pp, torch.as_tensor(x[:, :S]), pd, ppol,
                                  cache=pc)
        assert pc.length == S
        _close(po, jo, rel)
        jo, jc = jmla.mla_forward(jp, jnp.asarray(x[:, S:]), jd, jpol,
                                  cache=jc)
        po, pc = pmla.mla_forward(pp, torch.as_tensor(x[:, S:]), pd, ppol,
                                  cache=pc)
    assert pc.length == S + 1
    _close(po, jo, rel)
    _close(pc.c_kv, jc.c_kv, rel)
    _close(pc.k_rope, jc.k_rope, rel)


# ---------------------------------------------------------------------- MoE
def _moe_dims(n_shared):
    jd = dataclasses.replace(j_lite.SMOKE.moe, n_shared=n_shared)
    pd = dataclasses.replace(
        registry.get_config("deepseek-v2-lite-16b", smoke=True).moe,
        n_shared=n_shared)
    return jd, pd


def test_route_matches_jax_where_the_margin_allows():
    jd, pd = _moe_dims(2)
    T, D, E = 64, jd.d_model, jd.n_experts
    x = _x(7, T, D)
    w = _x(8, D, E) * 0.3   # wide logits: most rows have a clear top-k
    tp, ti, aux = jmoe._route(jnp.asarray(x), jnp.asarray(w), jd,
                              JPolicy.serve_default())
    pp, pi, paux = pmoe._route(torch.as_tensor(x), torch.as_tensor(w), pd,
                               PPolicy.serve_default())
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), -1))
    srt = np.sort(probs, -1)[:, ::-1]
    clear = (srt[:, jd.top_k - 1] - srt[:, jd.top_k]) > M23_BOUND
    assert clear.sum() >= T // 2
    assert np.array_equal(pi.numpy()[clear], np.asarray(ti)[clear])
    assert_matmul_close(pp[clear], np.asarray(tp)[clear])
    for key in ("moe_aux", "moe_zloss"):
        np.testing.assert_allclose(float(paux[key]), float(aux[key]),
                                   rtol=1e-5)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_forward_dense_matches_jax(n_shared, policy):
    jd, pd = _moe_dims(n_shared)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(9), jd)
    pp = _t(_np(jp))
    x = _x(10, 2, 9, jd.d_model)
    jo, jaux = jmoe.moe_forward_dense(jp, jnp.asarray(x), jd,
                                      getattr(JPolicy, policy)())
    with torch.no_grad():
        po, paux = pmoe.moe_forward(pp, torch.as_tensor(x), pd,
                                    getattr(PPolicy, policy)())
    _close(po, jo, POLICIES[policy])
    np.testing.assert_allclose(float(paux["moe_aux"]),
                               float(jaux["moe_aux"]), rtol=1e-5)


def test_batched_expert_launch_is_the_per_expert_loop():
    """One batched launch of (T, D) x (E, D, F) gives each expert's lone
    product, bit for bit (the kernels' plain versions here)."""
    jd, _ = _moe_dims(0)
    x = torch.as_tensor(_x(11, 24, jd.d_model))
    w = torch.as_tensor(_x(12, jd.n_experts, jd.d_model, jd.expert_ff))
    batched = mp_matmul(x, w, "M8")
    for e in range(jd.n_experts):
        assert torch.equal(batched[e], mp_matmul(x, w[e], "M8"))


def test_moe_forward_with_a_mesh_raises():
    """A mesh goes to the expert-parallel path (tests/test_torch_moe_ep.py),
    which refuses a mesh without the data and model axes it splits over."""
    import types

    _, pd = _moe_dims(0)
    mesh = types.SimpleNamespace(mesh_dim_names=("data",))
    with pytest.raises(ValueError, match="model"):
        pmoe.moe_forward({}, torch.zeros(1, 1, pd.d_model), pd,
                         PPolicy.serve_default(), mesh=mesh)


# ---------------------------------------------------------------------- SSM
SSM_J, SSM_P = j_mamba.SMOKE.ssm, registry.get_config(
    "mamba2-130m", smoke=True).ssm


def test_ssd_gradient_is_finite_over_a_long_chunk():
    """Over a 128-position chunk with many heads, cum_i - cum_j above the
    diagonal overflows exp: the JAX package masks after the exp and its
    gradient is NaN there (0 * inf); the port masks before it.  Forward
    within 1e-5 of JAX's, the port's gradients finite and equal to JAX's
    on every leaf JAX's are finite."""
    kw = dict(d_model=64, d_state=16, head_dim=4, expand=2, chunk=128)
    jd, pd = jssm.SSMDims(**kw), pssm.SSMDims(**kw)
    jp = jssm.init_ssm_params(jax.random.PRNGKey(5), jd)
    x = _x(21, 1, 128, 64)

    def jf(p):
        return jnp.sum(jssm.ssm_forward(p, jnp.asarray(x), jd,
                                        JPolicy.full_fp32())[0])

    from repro.core import context as jcontext

    with jcontext.context(backend="ref"):
        jy = jssm.ssm_forward(jp, jnp.asarray(x), jd, JPolicy.full_fp32())[0]
        jg = jax.grad(jf)(jp)
    pp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    py, _ = pssm.ssm_forward(pp, torch.as_tensor(x), pd, PPolicy.full_fp32())
    py.sum().backward()
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=1e-5 * np.abs(jy).max())
    nan_in_jax = [k for k, g in jg.items() if np.isnan(np.asarray(g)).any()]
    assert nan_in_jax   # the overflow this case is built to reach
    for k, g in jg.items():
        got = pp[k].grad.numpy()
        assert np.isfinite(got).all(), k
        if k not in nan_in_jax:
            g = np.asarray(g)
            assert np.abs(got - g).max() <= 5e-4 * np.abs(g).max(), k


def test_causal_conv_matches_jax():
    x, w, b = _x(13, 2, 10, 24), _x(14, 4, 24), _x(15, 24)
    win = _x(16, 2, 3, 24)
    for init in (None, win):
        ref = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b),
                                None if init is None else jnp.asarray(init))
        out = pssm._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                                torch.as_tensor(b),
                                None if init is None else torch.as_tensor(
                                    init))
        _close(out, ref, 2e-6)


@pytest.mark.parametrize("S", [32, 21])
def test_ssd_chunked_matches_jax(S):
    """y and the final state, at S a multiple of the chunk (16) and not."""
    d = SSM_J
    H, dh, G, ds = d.n_heads, d.head_dim, d.n_groups, d.d_state
    xh, Bm, Cm = _x(17, 2, S, H, dh), _x(18, 2, S, G, ds), _x(19, 2, S, G, ds)
    dt = np.abs(_x(20, 2, S, H)) * 0.1
    A = -np.arange(1, H + 1, dtype=np.float32) * 0.3
    jy, js = jssm._ssd_chunked(*(jnp.asarray(v) for v in (xh, dt, A, Bm,
                                                          Cm)),
                               d, JPolicy.full_fp32())
    py, ps = pssm._ssd_chunked(*(torch.as_tensor(v) for v in (xh, dt, A, Bm,
                                                              Cm)),
                               SSM_P, PPolicy.full_fp32())
    _close(py, jy, 1e-5)
    _close(ps, js, 1e-5)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_ssm_prefill_then_decode_matches_jax(policy):
    jp = jssm.init_ssm_params(jax.random.PRNGKey(21), SSM_J)
    pp = _t(_np(jp))
    jpol, ppol = getattr(JPolicy, policy)(), getattr(PPolicy, policy)()
    rel = POLICIES[policy]
    x = _x(22, 2, 19, SSM_J.d_model)
    jc = jssm.make_ssm_cache(2, SSM_J)
    pc = pssm.make_ssm_cache(2, SSM_P)
    jo, jc = jssm.ssm_forward(jp, jnp.asarray(x[:, :18]), SSM_J, jpol,
                              cache=jc)
    po, pc = pssm.ssm_forward(pp, torch.as_tensor(x[:, :18]), SSM_P, ppol,
                              cache=pc)
    _close(po, jo, rel)
    _close(pc.state, jc.state, rel)
    _close(pc.conv, jc.conv, rel)
    jo, jc = jssm.ssm_forward(jp, jnp.asarray(x[:, 18:]), SSM_J, jpol,
                              cache=jc)
    po, pc = pssm.ssm_forward(pp, torch.as_tensor(x[:, 18:]), SSM_P, ppol,
                              cache=pc)
    assert pc.length == 19
    _close(po, jo, rel)
    _close(pc.state, jc.state, rel)


def test_softplus_is_logaddexp_above_the_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 5.0, 20.5, 40.0])
    np.testing.assert_array_equal(
        pssm.softplus(x).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))))


# ------------------------------------------------------------------- hybrid
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_hybrid_attn_block_with_a_nonzero_lora_matches_jax(policy):
    cfg_j, cfg_p = j_zamba.SMOKE, p_zamba.SMOKE
    jparams = JT.init_params(cfg_j, jax.random.PRNGKey(23))
    np_params = _np(jparams)
    # JAX inits the LoRA b to zeros: give every group a nonzero one
    for side in ("q", "o"):
        b = np_params["shared_lora"][side]["b"]
        np_params["shared_lora"][side]["b"] = _x(24, *b.shape) * 0.1
    pparams = params_from_jax(np_params)
    jlora = jax.tree_util.tree_map(jnp.asarray, np_params["shared_lora"])
    x = _x(25, 2, 10, cfg_j.d_model)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(10)[None], (2, 10)))
    for g in range(cfg_j.n_layers // cfg_j.hybrid_attn_every):
        lora_g = jax.tree_util.tree_map(lambda v: v[g], jlora)
        jo, _ = JT._attn_block(jparams["shared_block"], jnp.asarray(x),
                               cfg_j, getattr(JPolicy, policy)(),
                               jnp.asarray(pos), None, lora=lora_g)
        with torch.no_grad():
            po, _ = PT._attn_block(pparams["shared_block"],
                                   torch.as_tensor(x), cfg_p,
                                   getattr(PPolicy, policy)(),
                                   torch.as_tensor(pos), None,
                                   lora=pparams["shared_lora"][g])
        _close(po, jo, POLICIES[policy])
        # the patch moved the output: the LoRA is live
        with torch.no_grad():
            plain, _ = PT._attn_block(pparams["shared_block"],
                                      torch.as_tensor(x), cfg_p,
                                      getattr(PPolicy, policy)(),
                                      torch.as_tensor(pos), None)
        assert not torch.allclose(plain, po)
