"""PyTorch port: every architecture id of the registry held against the JAX
package — parameter counts and shape-cell rules of the full configs, the
SMOKE forward's logits (the vlm patch prefix and the audio frame embeddings
and CTC head included), the port's own decode against its full forward,
``ServeEngine.generate``'s tokens, and the serve launcher.

Weights come from the JAX ``init_params`` through ``params_from_jax``; the
JAX forward runs on its ``ref`` backend, the port's kernel wrappers their
plain versions.  Logit tolerances are ``tests/test_torch_serve.py``'s:
``full_fp32`` at 1e-5 of the logits' scale (f32 summation order only),
``serve_default`` at M8's error bound of the scale."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import registry, shapes
from repro_torch.core.formats import resolve
from repro_torch.core.policy import PrecisionPolicy as PPolicy
from repro_torch.launch import serve as serve_launch
from repro_torch.models import transformer as PT
from repro_torch.serve.engine import ServeEngine
from repro_torch.weights import params_from_jax

M8_BOUND = resolve("M8").rel_err_bound
POLICIES = {"full_fp32": 1e-5, "serve_default": M8_BOUND}
DECODERS = [a for a in registry.ARCH_IDS
            if not registry.get_config(a, smoke=True).encoder_only]
PROMPTS = [np.arange(3, 14, dtype=np.int32), np.asarray([5, 6, 7, 8],
                                                        np.int32)]


def _configs(arch):
    return (jregistry.get_config(arch, smoke=True),
            registry.get_config(arch, smoke=True))


_PARAMS = {}


def _params(arch):
    """The JAX SMOKE params of ``arch`` (seed 0) and the port's copy."""
    if arch not in _PARAMS:
        jcfg, _ = _configs(arch)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp)))
    return _PARAMS[arch]


def _inputs(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    inputs = {}
    if cfg.family == "audio":
        inputs["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        inputs["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)
    if cfg.family == "vlm":
        inputs["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return inputs


def _torch_inputs(inputs):
    return {k: torch.as_tensor(v, dtype=torch.long) if k == "tokens"
            else torch.as_tensor(v) for k, v in inputs.items()}


def _jax_fields_of(port, jax):
    """JAX's ``asdict`` cut to the port's keys, the family dims' included:
    the port keeps only the fields it reads (a key JAX lacks raises)."""
    if isinstance(port, dict):
        return {k: _jax_fields_of(port[k], jax[k]) for k in port}
    return jax


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_counts_equal_jax_on_the_full_config(arch):
    jcfg, pcfg = jregistry.get_config(arch), registry.get_config(arch)
    for smoke in (False, True):  # every field the port has, nested too
        port = dataclasses.asdict(registry.get_config(arch, smoke))
        assert port == _jax_fields_of(
            port, dataclasses.asdict(jregistry.get_config(arch, smoke)))
    assert pcfg.param_count() == jcfg.param_count()
    assert pcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_shape_cells_equal_jax(arch):
    jcfg, pcfg = jregistry.get_config(arch), registry.get_config(arch)
    assert shapes.runnable_cells(pcfg) == jshapes.runnable_cells(jcfg)
    for name in shapes.SHAPE_ORDER:
        assert shapes.applicability(pcfg, name) == \
            jshapes.applicability(jcfg, name)
    assert registry.assigned_archs() == jregistry.assigned_archs()


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_smoke_forward_logits_match_jax(arch, policy):
    jcfg, pcfg = _configs(arch)
    jp, pp = _params(arch)
    inputs = _inputs(pcfg)
    jl, _, _ = JT.forward(jp, {k: jnp.asarray(v) for k, v in inputs.items()},
                          jcfg, getattr(JPolicy, policy)())
    with torch.no_grad():
        pl, _, _ = PT.forward(pp, _torch_inputs(inputs), pcfg,
                              getattr(PPolicy, policy)())
    jl = np.asarray(jl)
    assert pl.shape == jl.shape
    np.testing.assert_allclose(pl.numpy(), jl, rtol=0,
                               atol=POLICIES[policy] * np.abs(jl).max())


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_full_forward(arch):
    """The port's cached decode against its own full forward, as
    tests/test_arch_smoke.py holds the JAX package (below 3e-2)."""
    _, cfg = _configs(arch)
    _, params = _params(arch)
    policy = PPolicy.full_fp32()
    B, S = 2, 20
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)))
    with torch.no_grad():
        full, _, _ = PT.forward(params, {"tokens": toks}, cfg, policy)
        cache = PT.make_cache(cfg, B, 32, dtype=torch.float32)
        lg, _, cache = PT.forward(params, {"tokens": toks[:, :12]}, cfg,
                                  policy, cache=cache)
        outs = [lg[:, -1]]
        for i in range(12, S):
            lg, _, cache = PT.forward(params, {"tokens": toks[:, i:i + 1]},
                                      cfg, policy, cache=cache)
            outs.append(lg[:, -1])
    assert cache.length == S
    dec, ref = torch.stack(outs, dim=1), full[:, 11:S]
    err = ((dec - ref).abs().max() / ref.abs().max()).item()
    assert err < 3e-2, (arch, err)


@pytest.mark.parametrize("arch", DECODERS)
def test_generate_tokens_equal_jax_where_the_margin_allows(arch):
    jcfg, pcfg = _configs(arch)
    jp, pp = _params(arch)
    max_new = 4
    je = JEngine(jcfg, jp, max_batch=2, max_seq=32, prelimb_weights=False,
                 policy=JPolicy.serve_default())
    pe = ServeEngine(pcfg, pp, max_batch=2, max_seq=32, device="cpu",
                     policy=PPolicy.serve_default())
    j_out = je.generate(PROMPTS, max_new=max_new)
    p_out = pe.generate(PROMPTS, max_new=max_new)
    # the JAX stream's top-2 margins, teacher-forced through its steps
    toks = pe.pad_prompts(PROMPTS)
    jc = JT.make_cache(jcfg, 2, 32, dtype=jnp.float32)
    jl, jc = je._prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    logits, scale = np.asarray(jl)[:, -1], np.abs(np.asarray(jl)).max()
    tol = M8_BOUND * scale
    compared = 0
    live = [True, True]
    for step in range(max_new):
        top2 = np.sort(logits, -1)[:, -2:]
        for i in range(2):
            live[i] = live[i] and top2[i, 1] - top2[i, 0] > tol
            if live[i]:  # after a near-tie the streams may part
                assert p_out[i][step] == j_out[i][step], (arch, i, step)
                compared += 1
        tok = np.asarray([[o[step]] for o in j_out], np.int32)
        out, jc = je._decode(jp, jc, jnp.asarray(tok))
        logits = np.asarray(out)[:, -1]
    assert compared >= 1, arch


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_launcher_runs_every_decoder(arch, capsys):
    serve_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "req0" in out and "req1" in out and "tokens_per_s" in out


def test_serve_launcher_refuses_an_encoder_only_arch():
    with pytest.raises(SystemExit,
                       match="hubert-xlarge is encoder-only: no decode "
                             "serving"):
        serve_launch.main(["--arch", "hubert-xlarge", "--smoke",
                           "--device", "cpu"])
    with pytest.raises(SystemExit, match="full config on CPU: use --smoke"):
        serve_launch.main(["--arch", "deepseek-7b", "--device", "cpu"])


@pytest.mark.parametrize("arch", [
    a for a in DECODERS if registry.get_config(a, smoke=True).family
    != "dense" or registry.get_config(a, smoke=True).mla is not None])
def test_paged_serving_refuses_the_other_families(arch):
    """The scheduler and the paged / mixed steps stay dense-GQA only, as
    the JAX package's do (serve/scheduler.py, serve/engine.py)."""
    from repro_torch.core.lanes import envelope_of
    from repro_torch.serve.scheduler import ContinuousScheduler

    _, cfg = _configs(arch)
    eng = ServeEngine(cfg, _params(arch)[1], max_batch=2, max_seq=32,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="dense GQA"):
        ContinuousScheduler(eng, n_blocks=8, block_size=8)
    with pytest.raises(NotImplementedError, match="dense GQA"):
        eng.paged_steps_for(eng.policy)
    with pytest.raises(NotImplementedError, match="dense GQA"):
        eng.mixed_decode_step_for(envelope_of([eng.policy]))
