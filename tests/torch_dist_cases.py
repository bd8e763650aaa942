"""Cases the gloo ranks of ``torch_dist_pool.RankPool`` run: every rank
calls the same function with the same (numpy) arguments, inside the process
group, and returns numpy arrays or plain values.  Imports the port alone."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.core import context as context_lib
from repro_torch.core import dispatch
from repro_torch.dist import collectives
from repro_torch.launch import mesh as mesh_lib


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------- mesh
def meshes():
    """Cached meshes, axes and the production mesh's refusal."""
    m = mesh_lib.make_matmul_mesh()
    same = m is mesh_lib.make_matmul_mesh()
    d = mesh_lib.make_debug_mesh(data=2, model=2)
    try:
        mesh_lib.make_production_mesh()
        refused = False
    except RuntimeError:
        refused = True
    return {"matmul": mesh_lib.mesh_axes(m), "cached": same,
            "debug": mesh_lib.mesh_axes(d), "production_refused": refused}


# ---------------------------------------------------------------- collectives
def hier_psum(x, pod=2, data=2, model=1):
    mesh = mesh_lib.make_debug_mesh(data=data, model=model, pod=pod)
    collectives.reset_counts()
    x = _t(x)
    h = collectives.hierarchical_psum(x, mesh, pod_axis="pod",
                                      inner_axis="data")
    counts = collectives.counts()
    fl = collectives.flat_psum(x, mesh, ("pod", "data"))
    return _np(h), _np(fl), counts


def hier_psum_compressed(x, err, pod=2, data=2, model=1):
    mesh = mesh_lib.make_debug_mesh(data=data, model=model, pod=pod)
    out, new_e = collectives.hierarchical_psum_compressed(
        _t(x), _t(err), mesh, pod_axis="pod", inner_axis="data")
    ref = collectives.flat_psum(_t(x), mesh, ("pod", "data"))
    return _np(out), _np(new_e), _np(ref)


# ---------------------------------------------------------------- pipeline
def _layer_fn(lp, h):
    from repro_torch.core.mpmatmul import mp_dense

    y = mp_dense(h, lp["w1"], "M16")
    y = torch.nn.functional.gelu(y, approximate="tanh")  # jax.nn.gelu
    return h + mp_dense(y, lp["w2"], "M16")


def _sequential(params, x):
    h = x
    for i in range(params["w1"].shape[0]):
        h = _layer_fn({"w1": params["w1"][i], "w2": params["w2"][i]}, h)
    return h


def pipeline_fwd(params, x, n_micro, data=1, model=4):
    from repro_torch.dist import pipeline

    mesh = mesh_lib.make_debug_mesh(data=data, model=model)
    params = tree_lib.map_(_t, params)
    collectives.reset_counts()
    out = pipeline.pipeline_forward(_layer_fn, params, _t(x), mesh,
                                    n_micro=n_micro)
    counts = collectives.counts()
    return _np(out), _np(_sequential(params, _t(x))), counts


def pipeline_grads(params, x, n_micro, data=1, model=4):
    from repro_torch.dist import pipeline

    mesh = mesh_lib.make_debug_mesh(data=data, model=model)
    live = tree_lib.map_(lambda a: _t(a).requires_grad_(True), params)
    out = pipeline.pipeline_forward(_layer_fn, live, _t(x), mesh,
                                    n_micro=n_micro)
    (out ** 2).sum().backward()
    group = mesh.get_group("model")
    grads = {}
    for k, p in live.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        # each stage holds its own layers' gradients: the sum over the
        # stage axis is the whole model's (one term per element is not 0)
        grads[k] = _np(collectives.all_reduce(g.clone(), group))
    seq = tree_lib.map_(lambda a: _t(a).requires_grad_(True), params)
    (_sequential(seq, _t(x)) ** 2).sum().backward()
    return grads, {k: _np(p.grad) for k, p in seq.items()}


# ---------------------------------------------------------------- sharding
def shardings(shapes):
    """param_shardings / cache_specs specs under a few rule sets on a
    (data 2, model 2) mesh."""
    from repro_torch.dist import sharding as sh

    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    out = {}
    for tag, rules in {
            "tp": sh.AxisRules(mesh, batch_axes=("data",), tp_enabled=True),
            "fsdp": sh.AxisRules(mesh, batch_axes=("data", "model")),
            "none": sh.AxisRules(mesh)}.items():
        out[tag] = {k: v.spec for k, v in
                    sh.param_shardings(params, rules).items()}
        out["cache_" + tag] = sh.cache_specs(
            {k: v for k, v in params.items() if v.ndim >= 2}, rules,
            seq_axes="model")
    return out


def constrain_dtensor(x):
    """``constrain``: identity without rules and on a plain tensor; a
    DTensor moves to the named layout."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist import sharding as sh

    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    x = _t(x)
    same_plain = sh.constrain(x, "activations") is x
    rules = sh.AxisRules(mesh, batch_axes=("data",))
    d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    with sh.use_rules(rules):
        same_plain_rules = sh.constrain(x, "activations") is x
        c = sh.constrain(d, "activations")
    return {"plain": same_plain and same_plain_rules,
            "placements": [str(p) for p in c.placements],
            "local": _np(c.to_local()), "full": _np(c.full_tensor())}


def elastic_restore(ckpt_dir, step, like_shapes):
    """Restore a logically saved checkpoint onto this world's mesh under
    ``param_shardings``; each rank's local shard and its slice."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.dist import sharding as sh

    mesh = mesh_lib.make_matmul_mesh()
    like = {k: torch.zeros(s) for k, s in like_shapes.items()}
    rules = sh.AxisRules(mesh, batch_axes=("data",))
    shs = sh.param_shardings(like, rules)
    restored, extra = ckpt.restore(ckpt_dir, step, like, shardings=shs)
    return {k: (_np(v.to_local()), [str(p) for p in v.placements],
                tuple(v.shape)) for k, v in restored.items()}, extra


# ---------------------------------------------------------------- matmul
def sharded_matmul(a, b, modes, **kw):
    """mp_matmul under sharded for each mode; collective counts of each."""
    from repro_torch.core.mpmatmul import mp_matmul

    outs, counts = {}, {}
    for m in modes:
        collectives.reset_counts()
        outs[m] = _np(mp_matmul(_t(a), _t(b), m, backend="sharded", **kw))
        counts[m] = collectives.counts()["all_reduce"]
    return outs, counts


def sharded_grads(a, b, mode, bwd_mode):
    from repro_torch.core.mpmatmul import mp_matmul

    out = {}
    for backend in ("sharded", "cuda"):
        ta = _t(a).requires_grad_(True)
        tb = _t(b).requires_grad_(True)
        collectives.reset_counts()
        (mp_matmul(ta, tb, mode, backend=backend, bwd_mode=bwd_mode) ** 2
         ).sum().backward()
        out[backend] = (_np(ta.grad), _np(tb.grad),
                        collectives.counts()["all_reduce"]["calls"])
    return out


def sharded_fallbacks(a, b, a3, b3, pw_x, pw_w):
    """Inside an owned scope, a batched b, DD and pre-limbed operands: the
    sharded backend computes locally (the cuda route), no collective."""
    from repro_torch.core.limbs import dd_from_f64, prelimb_weight
    from repro_torch.core.mpmatmul import mp_dense, mp_matmul

    collectives.reset_counts()
    with dispatch.owned_axes("model"):
        owned = _np(mp_matmul(_t(a), _t(b), "M16", backend="sharded"))
    batched = _np(mp_matmul(_t(a3), _t(b3), "M16", backend="sharded"))
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    dd = _np(mp_matmul(dd_from_f64(a64, device="cpu"),
                       dd_from_f64(b64, device="cpu"), "M52",
                       backend="sharded"))
    pw = prelimb_weight(_t(pw_w), 3)
    pl = _np(mp_dense(_t(pw_x), pw, "M23", backend="sharded"))
    calls = collectives.counts()["all_reduce"]["calls"]
    local = {
        "owned": _np(mp_matmul(_t(a), _t(b), "M16", backend="cuda")),
        "batched": _np(mp_matmul(_t(a3), _t(b3), "M16", backend="cuda")),
        "dd": _np(mp_matmul(dd_from_f64(a64, device="cpu"),
                            dd_from_f64(b64, device="cpu"), "M52",
                            backend="cuda")),
        "prelimbed": _np(mp_dense(_t(pw_x), pw, "M23", backend="cuda"))}
    return {"owned": owned, "batched": batched, "dd": dd,
            "prelimbed": pl}, local, calls


def context_mesh(a, b):
    """A 1-D context mesh under any name shards; a 2-D mesh without a
    'data' axis raises."""
    import repro_torch.mp as mp
    from torch.distributed.device_mesh import init_device_mesh

    w = dist.get_world_size()
    mesh_x = init_device_mesh("cpu", (w,), mesh_dim_names=("x",))
    collectives.reset_counts()
    with mp.context(mesh=mesh_x):
        got = _np(mp.mp_matmul(_t(a), _t(b), "M16", backend="sharded"))
    calls = collectives.counts()["all_reduce"]["calls"]
    bad = init_device_mesh("cpu", (2, w // 2), mesh_dim_names=("rows",
                                                                "cols"))
    try:
        with mp.context(mesh=bad):
            mp.mp_matmul(_t(a), _t(b), "M16", backend="sharded")
        err = ""
    except ValueError as e:
        err = str(e)
    return got, calls, err


# ---------------------------------------------------------------- attention
def sp_decode(q, k, v, lengths, mode, mode_pv=None):
    from repro_torch.dist.attention import sp_decode_attention

    collectives.reset_counts()
    out = sp_decode_attention(_t(q), _t(k), _t(v), _t(lengths), mode,
                              mode_pv)
    counts = collectives.counts()["all_reduce"]
    again = sp_decode_attention(_t(q), _t(k), _t(v), _t(lengths), mode,
                                mode_pv)
    return _np(out), bool(torch.equal(out, again)), counts


def sp_routes(q, k, v, lengths):
    """masked_decode_attention and dispatch_attention (S == 1) under
    sharded; AUTO falling back to the local route."""
    collectives.reset_counts()
    masked = dispatch.masked_decode_attention(_t(q), _t(k), _t(v),
                                              _t(lengths), "M16",
                                              backend="sharded")
    n_masked = collectives.counts()["all_reduce"]["calls"]
    T = k.shape[1]
    probe = dispatch.dispatch_attention(_t(q), _t(k), _t(v), "M16",
                                        causal=True, q_offset=T - 1,
                                        backend="sharded")
    from repro_torch.dist.attention import sp_decode_attention

    auto = sp_decode_attention(_t(q), _t(k), _t(v), _t(lengths), "AUTO")
    auto_local = dispatch.masked_decode_attention(
        _t(q), _t(k), _t(v), _t(lengths), "AUTO", backend="cuda")
    return {"masked": _np(masked), "n_masked": n_masked,
            "probe": _np(probe), "auto": _np(auto),
            "auto_local": _np(auto_local)}


# ---------------------------------------------------------------- engine
def _smoke_params(jax_params):
    from repro_torch.configs import paper_mpfp
    from repro_torch.weights import params_from_jax

    return paper_mpfp.SMOKE, params_from_jax(jax_params)


def engine_generate(jax_params, prompts, max_new):
    """ServeEngine pinned to sharded vs the cuda backend, plus the
    collectives of one sharded generate."""
    from repro_torch.kernels import mp_matmul as kern
    from repro_torch.serve.engine import ServeEngine

    cfg, params = _smoke_params(jax_params)
    prompts = [np.asarray(p, np.int32) for p in prompts]
    ref = ServeEngine(cfg, params, max_batch=2, max_seq=48, device="cpu"
                      ).generate(prompts, max_new=max_new)
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=48, device="cpu",
                      matmul_backend="sharded")
    collectives.reset_counts()
    kern.mp_fused_matmul_partials.plain_calls = 0
    toks = eng.generate(prompts, max_new=max_new)
    return toks, ref, collectives.counts()["all_reduce"], \
        kern.mp_fused_matmul_partials.plain_calls


def scheduler_streams(jax_params, prompts, max_new):
    """ContinuousScheduler over a sharded engine (paged decode goes
    sequence-parallel) vs the cuda engine's."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousScheduler, \
        ScheduledRequest

    cfg, params = _smoke_params(jax_params)
    out = {}
    for backend in ("sharded", "cuda"):
        eng = ServeEngine(cfg, params, max_batch=4, max_seq=64,
                          device="cpu", matmul_backend=backend)
        s = ContinuousScheduler(eng, n_blocks=32, block_size=8)
        collectives.reset_counts()
        done = s.run([ScheduledRequest(rid=i, prompt=list(p),
                                       max_new=max_new, arrival=i)
                      for i, p in enumerate(prompts)])
        out[backend] = ({r.rid: list(r.out) for r in done},
                        collectives.counts()["all_reduce"]["calls"])
    return out


def train_value_and_grad(jax_params, tokens, labels):
    """One value_and_grad of the SMOKE model under sharded and cuda."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.train import trainer as trainer_lib

    cfg, params = _smoke_params(jax_params)
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    loss_fn = trainer_lib.make_loss_fn(cfg, PrecisionPolicy.train_default())
    out = {}
    for backend in ("sharded", "cuda"):
        collectives.reset_counts()
        with context_lib.context(backend=backend):
            (loss, _), grads = trainer_lib.value_and_grad(loss_fn, params,
                                                          batch)
        out[backend] = (float(loss), {p: _np(g) for p, g in
                                      tree_lib.items(grads)},
                        collectives.counts()["all_reduce"]["calls"])
    return out


# ---------------------------------------------------------------- MoE EP
def moe_ep(params, x, dims_kw, route_kw, ct=None, policy="full_fp32"):
    """moe_forward_ep on a (data 2, model 2) mesh: its output and aux, the
    collectives of the forward (and of the backward), and the dense
    oracle on the same params; with ``ct`` the gradients of
    sum(out * ct) + 0.01 aux + 1e-4 zloss w.r.t. x and every param."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import moe

    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    dims = moe.MoEDims(**dims_kw)
    grad = ct is not None
    p = tree_lib.map_(lambda a: _t(a).clone().requires_grad_(grad), params)
    xt = _t(x).clone().requires_grad_(grad)
    pol = getattr(PrecisionPolicy, policy)()
    collectives.reset_counts()
    out, aux = moe.moe_forward_ep(p, xt, dims, pol, mesh, **route_kw)
    res = {"out": _np(out),
           "aux": {k: float(v.detach()) for k, v in aux.items()},
           "fwd_counts": collectives.counts()}
    if grad:
        loss = ((out * _t(ct)).sum() + 0.01 * aux["moe_aux"]
                + 1e-4 * aux["moe_zloss"])
        leaves = [xt] + tree_lib.leaves(p)
        gs = torch.autograd.grad(loss, leaves)
        res["grads"] = {"x": _np(gs[0]), **{
            path: _np(g) for (path, _), g in zip(tree_lib.items(p), gs[1:])}}
        res["counts"] = collectives.counts()
    with torch.no_grad():
        dense, _ = moe.moe_forward_dense(p, xt, dims, pol)
    res["dense"] = _np(dense)
    return res


def _moe_smoke(jax_params):
    from repro_torch.configs import registry
    from repro_torch.weights import params_from_jax

    return (registry.get_config("deepseek-v2-lite-16b", smoke=True),
            params_from_jax(jax_params))


def moe_model_grads(jax_params, tokens, labels):
    """One value_and_grad of the MoE SMOKE model (loss with aux and
    z-loss) with the expert-parallel mesh and without (all experts), and
    the collectives of the mesh's run."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.train import trainer as trainer_lib

    cfg, params = _moe_smoke(jax_params)
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    out = {}
    for tag, m in (("ep", mesh), ("dense", None)):
        loss_fn = trainer_lib.make_loss_fn(cfg, PrecisionPolicy.full_fp32(),
                                           mesh=m)
        collectives.reset_counts()
        (loss, extras), grads = trainer_lib.value_and_grad(loss_fn, params,
                                                           batch)
        out[tag] = (float(loss), {k: float(v) for k, v in extras.items()},
                    {p: _np(g) for p, g in tree_lib.items(grads)},
                    collectives.counts())
    return out


def moe_model_serve_train(jax_params, prompts, max_new, ck_dir):
    """ServeEngine(mesh=...) on the MoE SMOKE (prefill on the split route,
    decode on the replicated one) against the one-rank engine; two
    Trainer.run steps with the mesh and without; the trained state's
    checkpoint restored with the experts by shard."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import sharding as sh
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import trainer as trainer_lib

    cfg, params = _moe_smoke(jax_params)
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    prompts = [np.asarray(p, np.int32) for p in prompts]
    pol = PrecisionPolicy.full_fp32()
    out = {}
    for tag, m in (("ep", mesh), ("dense", None)):
        eng = ServeEngine(cfg, params, max_batch=len(prompts), max_seq=48,
                          device="cpu", policy=pol, mesh=m)
        collectives.reset_counts()
        toks = eng.generate(prompts, max_new=max_new)
        out[f"generate_{tag}"] = (toks, collectives.counts())
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=9,
                                  global_batch=4))
    for tag, m in (("ep", mesh), ("dense", None)):
        rank_dir = f"{ck_dir}/rank{torch.distributed.get_rank()}"
        # aux weight 0: the load-balance aux is a mean over the ranks'
        # token slices with the mesh, over all tokens without
        tr = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(
            total_steps=10, warmup=2, ckpt_dir=rank_dir if m else "",
            ckpt_every=2, aux_weight=0.0), policy=pol, device="cpu", mesh=m)
        state = trainer_lib.TrainState(params, adamw.init(params,
                                                          tr.tcfg.opt))
        state, hist = tr.run(pipe, num_steps=2, log_every=0, state=state)
        out[f"train_{tag}"] = hist
        if m is not None:
            shs = sh.expert_shardings(state, mesh)
            got, _ = ckpt_lib.restore(rank_dir, 2, state, shardings=shs)
            got = got.params
            w = got["layers"][0]["moe"]["w_gate"]
            full = state.params["layers"][0]["moe"]["w_gate"]
            E, D = full.shape[:2]
            mi, di = mesh.get_local_rank("model"), mesh.get_local_rank("data")
            out["restore"] = (
                _np(w.to_local()),
                _np(full[mi * E // 2:(mi + 1) * E // 2,
                         di * D // 2:(di + 1) * D // 2]),
                tuple(w.shape),
                _np(got["layers"][0]["moe"]["router"].to_local()),
                _np(state.params["layers"][0]["moe"]["router"]))
    return out


# ---------------------------------------------------------------- FSDP
def _fsdp_cfg(arch, overrides):
    import dataclasses

    from repro_torch.configs import registry

    return dataclasses.replace(registry.get_config(arch, smoke=True),
                               **(overrides or {}))


def _fsdp_trainer(cfg, mesh, batch, **tcfg_kw):
    """A trainer on the layout the port's ``make_rules`` gives a train cell
    of ``batch``'s rows on ``mesh`` (``specs.fsdp_layout``, as the launcher
    and the dry run take it)."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.launch import specs
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_lib

    B, S = batch["labels"].shape
    if cfg.family == "vlm":
        S += cfg.n_patches
    cell = ShapeCell("smoke", S, B, "train")
    layout = specs.fsdp_layout(cfg, cell, specs.make_rules(mesh, cell, cfg))
    assert layout is not None, "make_rules gives this cell no FSDP layout"
    tcfg = trainer_lib.TrainerConfig(opt=adamw.AdamWConfig(lr=1e-3),
                                     total_steps=30, warmup=2, **tcfg_kw)
    return trainer_lib.Trainer(cfg, tcfg, policy=PrecisionPolicy
                               .train_default(), device="cpu", layout=layout)


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def batch(self, step):
        return self.batches[step]


def _state(cfg, jax_params, opt_cfg):
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_lib
    from repro_torch.weights import params_from_jax

    params = params_from_jax(jax_params)
    return trainer_lib.TrainState(params, adamw.init(params, opt_cfg))


def fsdp_blocks(runs):
    """Each run (arch, overrides, a numbered global train state and batch
    of the port's structure): this rank's mesh coordinates, its block of
    every state leaf under the trainer's layout and its rows of the
    batch."""
    from repro_torch.dist import fsdp

    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    out = {"coord": tuple(mesh.get_coordinate())}
    for name, (arch, overrides, state, batch) in runs.items():
        tr = _fsdp_trainer(_fsdp_cfg(arch, overrides), mesh, batch)
        state = tree_lib.map_(_t, state)
        blocks = fsdp.shard_tree(state, tr.state_shardings())
        out[name] = ({p: _np(x) for p, x in tree_lib.items(blocks)},
                     {k: _np(v) for k, v in tr.to_device(batch).items()})
    return out


def fsdp_vs_one_rank(arch, overrides, jax_params, batch):
    """One train_default step of a SMOKE config under the FSDP layout on a
    (data 2, model 2) mesh and on one rank (this process, the whole batch):
    each rank's rows' logits and the one-rank logits of the same rows, the
    gathered gradients and the one-rank ones, the step's loss, metrics,
    new state (gathered) and collectives, the one-rank step's."""
    from repro_torch.dist import fsdp
    from repro_torch.models import transformer as T
    from repro_torch.train import trainer as trainer_lib

    cfg = _fsdp_cfg(arch, overrides)
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    tr = _fsdp_trainer(cfg, mesh, batch)
    layout = tr.layout
    full = _state(cfg, jax_params, tr.tcfg.opt)
    local = fsdp.shard_tree(full, tr.state_shardings())
    gb = {k: _t(v) for k, v in batch.items()}
    lb = tr.to_device(batch)
    inputs = lambda b: {k: v for k, v in b.items() if k != "labels"}  # noqa
    with torch.no_grad():
        with fsdp.use_layout(layout):
            logits = T.forward(local.params, inputs(lb), cfg, tr.policy)[0]
        one_logits = T.forward(full.params, inputs(gb), cfg, tr.policy)[0]
    loss_fn = trainer_lib.make_loss_fn(cfg, tr.policy, tr.tcfg)
    (_, _), g_loc = trainer_lib.value_and_grad(
        fsdp.local_loss(loss_fn, layout), local.params, lb)
    (_, _), g_one = trainer_lib.value_and_grad(loss_fn, full.params, gb)
    collectives.reset_counts()
    new, metrics = tr._step_fn(local, lb)
    counts = collectives.counts()
    one_step = trainer_lib.make_train_step(cfg, tr.policy, tr.tcfg)
    collectives.reset_counts()
    one_new, one_metrics = one_step(full, gb)
    one_counts = collectives.counts()
    rows = tr.to_device({"r": np.arange(len(batch["labels"]))})["r"]
    new_full = fsdp.full_tree(new, tr.state_shardings())
    reps = {p: _np(x) for (p, x), (_, s) in zip(
        tree_lib.items(new), tree_lib.items(tr.state_shardings()))
        if not fsdp.is_sharded(s)}
    as_np = lambda t: {p: _np(x) for p, x in tree_lib.items(t)}  # noqa
    return {
        "rows": _np(rows), "logits": _np(logits),
        "one_logits": _np(one_logits),
        "grads": as_np(fsdp.full_tree(g_loc, layout.params)),
        "one_grads": as_np(g_one),
        "metrics": {k: _np(v) for k, v in metrics.items()},
        "one_metrics": {k: _np(v) for k, v in one_metrics.items()},
        "new": as_np(new_full), "one_new": as_np(one_new),
        "replicated": reps, "counts": counts, "one_counts": one_counts,
        "local_bytes": sum(x.numel() * x.element_size()
                           for x in tree_lib.leaves(local)),
        "sharded": {p: fsdp.is_sharded(s)
                    for p, s in tree_lib.items(layout.params)},
    }


def fsdp_jax_steps(jax_params, batches):
    """paper-mpfp-100m SMOKE under the layout: one step's gathered new
    state and loss from ``batches[0]``, then ``Trainer.run`` over all of
    ``batches`` from the same state (its losses)."""
    from repro_torch.dist import fsdp

    cfg = _fsdp_cfg("paper-mpfp-100m", None)
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    tr = _fsdp_trainer(cfg, mesh, batches[0])
    local = fsdp.shard_tree(_state(cfg, jax_params, tr.tcfg.opt),
                            tr.state_shardings())
    new, metrics = tr._step_fn(local, tr.to_device(batches[0]))
    new = fsdp.full_tree(new, tr.state_shardings())

    _, hist = tr.run(_Batches(batches), num_steps=len(batches), log_every=0,
                     state=local)
    return {"loss": float(metrics["loss"]),
            "new": {p: _np(x) for p, x in tree_lib.items(new)},
            "history": hist}


def fsdp_checkpoints(jax_params, batches, ck4, ck1):
    """Two ``Trainer.run`` steps under the layout checkpointing into
    ``ck4`` (rank 0 writes the global arrays): the gathered state; then a
    trainer restoring ``ck1`` (a one-rank checkpoint): this rank's blocks
    of it."""
    from repro_torch.dist import fsdp

    cfg = _fsdp_cfg("paper-mpfp-100m", None)
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    tr = _fsdp_trainer(cfg, mesh, batches[0], ckpt_dir=ck4, ckpt_every=2)
    local = fsdp.shard_tree(_state(cfg, jax_params, tr.tcfg.opt),
                            tr.state_shardings())

    state, _ = tr.run(_Batches(batches), num_steps=2, log_every=0, state=local)
    gathered = fsdp.full_tree(state, tr.state_shardings())
    tr1 = _fsdp_trainer(cfg, mesh, batches[0], ckpt_dir=ck1)
    restored, data_step = tr1.maybe_restore(tr1.init_state())
    return {"gathered": {p: _np(x) for p, x in tree_lib.items(gathered)},
            "restored": {p: _np(x) for p, x in tree_lib.items(restored)},
            "data_step": data_step, "coord": tuple(mesh.get_coordinate())}


def fsdp_nan_rollback(jax_params, batches, ck_dir):
    """test_torch_train.py's NaN rollback under the layout: at the fifth
    step rank 0 alone poisons one block of its second moments, so only its
    block of the new parameters is NaN (the loss stays finite); every rank
    must roll back to the last checkpoint and escalate together."""
    from repro_torch.core.classify import all_finite
    from repro_torch.dist import fsdp
    from repro_torch.train import trainer as trainer_lib

    cfg = _fsdp_cfg("paper-mpfp-100m", None)
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    tr = _fsdp_trainer(cfg, mesh, batches[0], ckpt_dir=ck_dir, ckpt_every=2,
                        keep=2)
    real_fn = tr._step_fn
    seen = {"n": 0, "finite": [], "loss": []}

    def poisoned(state, batch):
        seen["n"] += 1
        if seen["n"] == 5 and dist.get_rank() == 0:
            v = tree_lib.map_(lambda x: x, state.opt.v)
            v["layers"][0]["mlp"]["w_up"] = torch.full_like(
                v["layers"][0]["mlp"]["w_up"], float("nan"))
            state = trainer_lib.TrainState(state.params,
                                           state.opt._replace(v=v))
        new_state, metrics = real_fn(state, batch)
        seen["finite"].append(float(metrics["params_finite"]))
        seen["loss"].append(float(metrics["loss"]))
        return new_state, metrics

    tr._step_fn = poisoned

    local = fsdp.shard_tree(_state(cfg, jax_params, tr.tcfg.opt),
                            tr.state_shardings())
    state, hist = tr.run(_Batches(batches), num_steps=8, log_every=0, state=local)
    return {"rollbacks": tr.rollbacks, "history": hist,
            "escalated": tr._escalated_fn is not None,
            "finite": bool(all_finite(state.params)),
            "step_finite": seen["finite"], "step_loss": seen["loss"]}


# ---------------------------------------------------------------- decode layout
def cache_items(cache):
    """(path, tensor) of every tensor of a per-layer ``ModelCache``:
    ``<group>/<layer>/<field>``."""
    import dataclasses

    out = []
    for group in ("attn", "dense_attn", "ssm", "shared_attn"):
        for i, c in enumerate(getattr(cache, group) or []):
            for f in dataclasses.fields(c):
                v = getattr(c, f.name)
                if isinstance(v, torch.Tensor):
                    out.append((f"{group}/{i}/{f.name}", v))
    return out


def _decode_layout(cfg, B, S, mesh):
    """The decode layout ``launch/specs`` gives a decode cell of B rows and
    a cache of S positions on ``mesh``."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import specs

    cell = ShapeCell("smoke", S, B, "decode")
    layout = specs.decode_layout(cfg, cell, specs.make_rules(mesh, cell,
                                                             cfg))
    assert layout is not None, "no decode layout for this cell"
    return layout


def decode_blocks(runs):
    """Each run (arch, B, S, a numbered global cache of the port's
    structure): this rank's block of every cache tensor under the decode
    layout, its rows, and its block of the cache sequence."""
    from repro_torch.configs import registry
    from repro_torch.dist import decode_layout as dl

    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    out = {"coord": tuple(mesh.get_coordinate())}
    for name, (arch, B, S, cache) in runs.items():
        layout = _decode_layout(registry.get_config(arch, smoke=True), B, S,
                                mesh)
        blocks = dl.shard_cache(cache, layout)
        rows = layout.rows(B)
        out[name] = ({p: _np(x) for p, x in cache_items(blocks)},
                     (rows.start, rows.stop),
                     layout.seq_block if layout.seq is not None else None)
    return out


def _decode_inputs(cfg, B, n_tok, seed=0):
    rng = np.random.default_rng(seed)
    inputs = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                     (B, n_tok)))}
    if cfg.family == "vlm":
        inputs["patch_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return inputs


def _clone_cache(cache):
    from repro_torch.dist import sharding as sh_lib

    return sh_lib.map_cache(lambda name, x: x.clone(), cache)


def decode_vs_one_rank(arch, B, S, length, steps, policy="serve_default"):
    """A SMOKE model's cache prefilled to ``length`` positions on every
    rank (the same on each), then ``steps`` decode steps teacher-forced on
    fixed tokens: on the decode layout of a (data 2, model 2) mesh (this
    rank's parameter blocks, cache blocks and rows) and on one rank (this
    process, the whole cache).  Each step's logits, the gathered cache
    after the steps, the collectives of each step, the rank's resident
    bytes."""
    from repro_torch.configs import registry
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import decode_layout as dl
    from repro_torch.dist import fsdp
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import make_prefill_step, make_serve_step

    cfg = registry.get_config(arch, smoke=True)
    pol = getattr(PrecisionPolicy, policy)()
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    layout = _decode_layout(cfg, B, S, mesh)
    params = T.init_params(cfg, seed=0)
    n_tok = length - (cfg.n_patches if cfg.family == "vlm" else 0)
    with torch.no_grad():
        _, cache = make_prefill_step(cfg, pol)(
            params, _decode_inputs(cfg, B, n_tok),
            T.make_cache(cfg, B, S))
    assert cache.length == length
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (steps, B, 1)))
    from repro_torch import kernels

    one_cache, one_logits, one_calls = _clone_cache(cache), [], []
    one = make_serve_step(cfg, pol)
    with torch.no_grad():
        for t in toks:
            kernels.reset_launch_counts()
            lg, one_cache = one(params, one_cache, t)
            one_calls.append(kernels.plain_call_counts())
            one_logits.append(_np(lg[:, -1]))
    rows = layout.rows(B)
    lp = fsdp.shard_tree(params, layout.fsdp.params) \
        if layout.fsdp is not None else params
    local = dl.shard_cache(cache, layout)
    resident = sum(x.numel() * x.element_size()
                   for x in tree_lib.leaves(lp)) + sum(
        x.numel() * x.element_size() for _, x in cache_items(local))
    step = make_serve_step(cfg, pol, layout=layout)
    logits, counts, calls = [], [], []
    for t in toks:
        collectives.reset_counts()
        kernels.reset_launch_counts()
        lg, local = step(lp, local, t[rows])
        counts.append(collectives.counts())
        calls.append(kernels.plain_call_counts())
        logits.append(_np(lg[:, -1]))
    assert local.length == length + steps
    first = next(((p, x) for p, x in cache_items(local)
                  if p.split("/")[-1] in ("k", "c_kv")), None)
    full = dl.full_cache(local, layout)
    return {"coord": tuple(mesh.get_coordinate()),
            "rows": (rows.start, rows.stop), "logits": logits,
            "one_logits": one_logits,
            "seq_block": layout.seq_block if layout.seq is not None
            else None,
            "cache": {p: _np(x.float()) for p, x in cache_items(full)},
            "one_cache": {p: _np(x.float())
                          for p, x in cache_items(one_cache)},
            "counts": counts, "resident": resident,
            "calls": calls, "one_calls": one_calls,
            "first_block": (first[0], _np(first[1].float()))
            if first is not None else None,
            "sharded_params": [p for p, s in tree_lib.items(
                layout.fsdp.params)
                if fsdp.is_sharded(s)] if layout.fsdp is not None else []}


def decode_jax_step(arch, B, S, np_params, np_cache, tokens):
    """One serve_default step of a SMOKE model on the decode layout from a
    JAX cache (``cache_from_jax``) and JAX's parameters: this rank's rows'
    logits and the gathered new cache."""
    from repro_torch.configs import registry
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import decode_layout as dl
    from repro_torch.dist import fsdp
    from repro_torch.serve.engine import make_serve_step
    from repro_torch.weights import cache_from_jax, params_from_jax

    cfg = registry.get_config(arch, smoke=True)
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    layout = _decode_layout(cfg, B, S, mesh)
    params = params_from_jax(np_params)
    lp = fsdp.shard_tree(params, layout.fsdp.params) \
        if layout.fsdp is not None else params
    local = dl.shard_cache(cache_from_jax(np_cache), layout)
    rows = layout.rows(B)
    step = make_serve_step(cfg, PrecisionPolicy.serve_default(),
                           layout=layout)
    lg, local = step(lp, local, _t(tokens)[rows])
    full = dl.full_cache(local, layout)
    return {"rows": (rows.start, rows.stop), "logits": _np(lg[:, -1]),
            "length": local.length,
            "cache": {p: _np(x.float()) for p, x in cache_items(full)}}


def decode_edges(q, k, v, lengths, junk):
    """sp_decode_block over this rank's block of the sequence group
    (data, model) of a whole K / V: with the positions past every length
    holding zeros and holding finite junk (a block with no valid position
    adds nothing); and the sharded backend's sp_decode_attention against
    the formula it had before sp_decode_block split from it."""
    from repro_torch.dist import attention as dist_attn
    from repro_torch.kernels import ref as ref_backend

    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    group = collectives.axis_group(mesh, ("data", "model"))
    idx, n = 2 * mesh.get_coordinate()[0] + mesh.get_coordinate()[1], 4
    q, k, v, junk = _t(q), _t(k), _t(v), _t(junk)
    T = k.shape[1]
    t = T // n
    blk = slice(idx * t, (idx + 1) * t)
    valid = (torch.arange(T)[None, :, None, None]
             < _t(lengths).reshape(-1, 1, 1, 1))
    dirty_k = torch.where(valid, k, junk)
    dirty_v = torch.where(valid, v, -junk)
    collectives.reset_counts()
    clean = dist_attn.sp_decode_block(q, k[:, blk], v[:, blk], _t(lengths),
                                      idx * t, group, "M16")
    counts = collectives.counts()["all_reduce"]
    dirty = dist_attn.sp_decode_block(q, dirty_k[:, blk], dirty_v[:, blk],
                                      _t(lengths), idx * t, group, "M16")
    try:
        dist_attn.sp_decode_block(q, k[:, blk], v[:, blk], _t(lengths),
                                  idx * t, group, "AUTO")
        auto = ""
    except ValueError as e:
        auto = str(e)

    # the sharded backend's entry against its formula before the split
    dmesh = mesh_lib.make_debug_mesh(data=4, model=1)
    sp = dist_attn.sp_decode_attention(q, k, v, _t(lengths), "M8", "M16",
                                       mesh=dmesh, axis="data")
    r = dmesh.get_local_rank("data")
    dgroup = dmesh.get_group("data")
    t_loc = -(-T // 4)
    t0, t1 = min(r * t_loc, T), min((r + 1) * t_loc, T)
    k_loc, v_loc = k[:, t0:t1], v[:, t0:t1]
    ln = torch.as_tensor(_t(lengths)).reshape(-1, 1, 1, 1)
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    qh = q.permute(0, 2, 1, 3).float() * scale
    kh = k_loc.permute(0, 2, 1, 3).float()
    vh = v_loc.permute(0, 2, 1, 3).float()
    from repro_torch.core.formats import resolve

    logits = ref_backend.attn_qk_logits(qh, kh, resolve("M8"),
                                        dot=ref_backend._dot_nt)
    pos = r * t_loc + torch.arange(t_loc)
    mask = pos < ln
    logits = torch.where(mask, logits,
                         torch.full((), ref_backend.ATTN_NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=dgroup)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros(()))
    den = p.sum(dim=-1, keepdim=True)
    dist.all_reduce(den, group=dgroup)
    acc = ref_backend.attn_pv(p, vh, resolve("M16"))
    dist.all_reduce(acc, group=dgroup)
    before = (acc / torch.clamp(den, min=1e-30)).permute(0, 2, 1, 3).to(
        q.dtype)
    return {"clean": _np(clean), "dirty": _np(dirty), "counts": counts,
            "auto": auto, "block": (idx * t, t),
            "sp_bits": bool(torch.equal(sp, before)), "sp": _np(sp)}


# ---------------------------------------------------------------- Ulysses
def ulysses_inputs(cfg, B, S, seed=11):
    """A global batch of B rows of S positions (numpy, seeded): tokens
    (the VLM's after its patches) or the audio family's frame embeddings,
    the VLM's patch embeddings, and labels."""
    rng = np.random.default_rng(seed)
    P = cfg.n_patches if cfg.family == "vlm" else 0
    out = {}
    if cfg.family == "audio":
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, S - P)).astype(
            np.int64)
    if P:
        out["patch_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab, (B, S - P)).astype(np.int64)
    return out


def _ulysses_layout(cfg, B, S, phase, mesh):
    """The Ulysses layout ``launch/specs`` gives a cell of B rows of S
    positions on ``mesh``."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import specs

    cell = ShapeCell("smoke", S, B, phase)
    layout = specs.seq_layout(cfg, cell, specs.make_rules(mesh, cell, cfg))
    assert layout is not None, "make_rules gives this cell no Ulysses layout"
    return layout


def _ulysses_trainer(cfg, layout, **tcfg_kw):
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_lib

    tcfg = trainer_lib.TrainerConfig(opt=adamw.AdamWConfig(lr=1e-3),
                                     total_steps=30, warmup=2, **tcfg_kw)
    return trainer_lib.Trainer(cfg, tcfg, policy=PrecisionPolicy
                               .train_default(), device="cpu", layout=layout)


def ulysses_blocks(runs):
    """Each run (arch, overrides, phase, B, S, a numbered global train
    state (train) or parameters (prefill), a numbered batch, a numbered
    cache or None): this rank's mesh coordinates, and under the layout its
    block of every state leaf, its rows of the batch, its cache blocks,
    its block of the sequence and its attention mode."""
    from repro_torch.dist import fsdp
    from repro_torch.dist import decode_layout as dl

    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    out = {"coord": tuple(mesh.get_coordinate())}
    for name, (arch, ov, phase, B, S, state, batch, cache) in runs.items():
        cfg = _fsdp_cfg(arch, ov)
        layout = _ulysses_layout(cfg, B, S, phase, mesh)
        shardings = (_ulysses_trainer(cfg, layout).state_shardings()
                     if phase == "train" else layout.params)
        blocks = fsdp.shard_tree(tree_lib.map_(_t, state), shardings)
        rows = layout.rows(B)
        got_cache = None
        if cache is not None:
            got_cache = {p: _np(x) for p, x in cache_items(
                dl.shard_cache(cache, layout))}
        out[name] = ({p: _np(x) for p, x in tree_lib.items(blocks)},
                     {k: v[rows] for k, v in batch.items()}, got_cache,
                     layout.block, layout.mode(max(1, cfg.n_heads)))
    return out


def _counted_calls(fn):
    """``fn()``, the collectives it called ({name: (calls, bytes)}) and
    the kernel wrappers' plain calls."""
    from repro_torch import kernels

    collectives.reset_counts()
    kernels.reset_launch_counts()
    out = fn()
    coll = {k: (v["calls"], v["bytes"]) for k, v in
            collectives.counts().items() if v["calls"]
            and k in collectives.COLLECTIVES}
    return out, coll, {k: v for k, v in kernels.plain_call_counts().items()
                       if v}


def ulysses_vs_one_rank(arch, overrides, B, S, fused_max=None,
                        prefill=True):
    """A SMOKE model (random weights, seed 0) on the Ulysses layout of a
    (data 2, model 2) mesh and on one rank (this process, the whole
    batch), on the same inputs: the forward's logits of the rank's rows
    and block and the one-rank ones there; the loss and gradients
    (gathered) of a train_default value-and-grad; one train step's
    collectives, metrics and plain calls; a prefill's last logits and
    gathered cache (``prefill``; an encoder its last logits) and its
    collectives.  ``fused_max``: the attention route's threshold
    (``models.attention.FUSED_P_MAX_ELEMENTS``) for the run, e.g. 0 for
    the chunk-scan at these sizes."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import fsdp
    from repro_torch.dist import decode_layout as dl
    from repro_torch.dist import seq_layout as sl
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import make_prefill_step
    from repro_torch.train import trainer as trainer_lib

    cfg = _fsdp_cfg(arch, overrides)
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    saved = attn_lib.FUSED_P_MAX_ELEMENTS
    if fused_max is not None:
        attn_lib.FUSED_P_MAX_ELEMENTS = fused_max
    try:
        layout = _ulysses_layout(cfg, B, S, "train", mesh)
        tr = _ulysses_trainer(cfg, layout)
        pol = tr.policy
        params = T.init_params(cfg, seed=0)
        gb = {k: _t(v) for k, v in ulysses_inputs(cfg, B, S).items()}
        lb = tr.to_device({k: v.numpy() for k, v in gb.items()})
        rows = layout.rows(B)
        off, t = layout.block
        lp = fsdp.shard_tree(params, layout.params)
        inputs = lambda b: {k: v for k, v in b.items() if k != "labels"}  # noqa
        with torch.no_grad():
            with sl.use_seq_layout(layout), \
                    context_lib.context(backend="cuda"):
                logits, _, fwd_calls = _counted_calls(
                    lambda: T.forward(lp, inputs(lb), cfg, pol)[0])
            one_logits, _, one_calls = _counted_calls(
                lambda: T.forward(params, inputs(gb), cfg, pol)[0])
        out = {"coord": tuple(mesh.get_coordinate()),
               "rows": (rows.start, rows.stop), "block": (off, t),
               "mode": layout.mode(max(1, cfg.n_heads)),
               "logits": _np(logits),
               "one_logits": _np(one_logits[rows, off:off + t]),
               "fwd_calls": fwd_calls, "one_fwd_calls": one_calls}
        loss_fn = trainer_lib.make_loss_fn(cfg, pol, tr.tcfg, layout=layout)
        one_fn = trainer_lib.make_loss_fn(cfg, pol, tr.tcfg)
        with context_lib.context(backend="cuda"):
            (loss, _), g = trainer_lib.value_and_grad(loss_fn, lp, lb)
        (one_loss, _), one_g = trainer_lib.value_and_grad(one_fn, params, gb)
        state = tr.init_state()
        (new, metrics), coll, calls = _counted_calls(
            lambda: tr._step_fn(state, lb))
        out.update(
            loss=float(collectives.all_reduce(loss.clone(),
                                              layout.metrics_group)),
            one_loss=float(one_loss),
            grads={p: _np(x) for p, x in tree_lib.items(
                fsdp.full_tree(g, layout.params))},
            one_grads={p: _np(x) for p, x in tree_lib.items(one_g)},
            step_collectives=coll, step_calls=calls,
            metrics={k: _np(v) for k, v in metrics.items()},
            sharded=[p for p, s in tree_lib.items(layout.params)
                     if fsdp.is_sharded(s)],
            state_bytes=sum(x.numel() * x.element_size()
                            for x in tree_lib.leaves(state)),
            batch_bytes=sum(x.numel() * x.element_size()
                            for x in lb.values()))
        if not prefill:
            return out
        pl = _ulysses_layout(cfg, B, S, "prefill", mesh)
        lp = fsdp.shard_tree(params, pl.params)
        pin = inputs(lb)
        with torch.no_grad():
            if cfg.encoder_only:
                one_last, _ = make_prefill_step(cfg, pol)(
                    params, inputs(gb), None)
                (last, _), coll, calls = _counted_calls(
                    lambda: make_prefill_step(cfg, pol, layout=pl)(
                        lp, pin, None))
                full = one_full = {}
            else:
                one_last, one_cache = make_prefill_step(cfg, pol)(
                    params, inputs(gb), T.make_cache(cfg, B, S))
                local = dl.shard_cache(T.make_cache(cfg, B, S), pl)
                (last, local), coll, calls = _counted_calls(
                    lambda: make_prefill_step(cfg, pol, layout=pl)(
                        lp, pin, local))
                assert local.length == S
                full = {p: _np(x.float()) for p, x in cache_items(
                    dl.full_cache(local, pl))}
                one_full = {p: _np(x.float())
                            for p, x in cache_items(one_cache)}
                out["cache_bytes"] = sum(x.numel() * x.element_size()
                                         for _, x in cache_items(local))
        out.update(last=_np(last), one_last=_np(one_last[rows]),
                   cache=full, one_cache=one_full,
                   prefill_collectives=coll, prefill_calls=calls,
                   params_bytes=sum(x.numel() * x.element_size()
                                    for x in tree_lib.leaves(lp)))
        return out
    finally:
        attn_lib.FUSED_P_MAX_ELEMENTS = saved



def ulysses_jax_steps(arch, overrides, np_params, batch, S, np_cache):
    """A SMOKE model on the Ulysses layout of a (data 2, model 2) mesh from
    JAX's parameters: one train_default step from the global batch (the
    gathered new state, the loss) and a serve_default prefill of its
    inputs into JAX's empty cache (this rank's rows' last logits, the
    gathered cache)."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import fsdp
    from repro_torch.dist import decode_layout as dl
    from repro_torch.serve.engine import make_prefill_step
    from repro_torch.weights import cache_from_jax, params_from_jax

    cfg = _fsdp_cfg(arch, overrides)
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    B = len(batch["labels"])
    layout = _ulysses_layout(cfg, B, S, "train", mesh)
    tr = _ulysses_trainer(cfg, layout)
    local = fsdp.shard_tree(_state(cfg, np_params, tr.tcfg.opt),
                            tr.state_shardings())
    new, metrics = tr._step_fn(local, tr.to_device(batch))
    new = fsdp.full_tree(new, tr.state_shardings())
    pl = _ulysses_layout(cfg, B, S, "prefill", mesh)
    rows = pl.rows(B)
    inputs = {k: _t(v)[rows] for k, v in batch.items() if k != "labels"}
    last, cache = make_prefill_step(cfg, PrecisionPolicy.serve_default(),
                                    layout=pl)(
        fsdp.shard_tree(params_from_jax(np_params), pl.params), inputs,
        dl.shard_cache(cache_from_jax(np_cache), pl))
    return {"loss": float(metrics["loss"]),
            "new": {p: _np(x) for p, x in tree_lib.items(new)},
            "rows": (rows.start, rows.stop), "last": _np(last),
            "cache": {p: _np(x.float()) for p, x in cache_items(
                dl.full_cache(cache, pl))}}


def ulysses_edges(S_bad):
    """Without a usable block: the SSM family at a block that is not a
    multiple of its SSD chunk, and a prefill into a cache longer than the
    prompt; each error's message."""
    from repro_torch.configs import registry
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import fsdp
    from repro_torch.dist import decode_layout as dl
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import make_prefill_step

    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    pol = PrecisionPolicy.serve_default()
    out = {}
    cfg = registry.get_config("mamba2-130m", smoke=True)
    layout = _ulysses_layout(cfg, 2, S_bad, "prefill", mesh)
    inputs = {k: _t(v)[layout.rows(2)] for k, v in
              ulysses_inputs(cfg, 2, S_bad).items() if k != "labels"}
    params = fsdp.shard_tree(T.init_params(cfg), layout.params)
    try:
        make_prefill_step(cfg, pol, layout=layout)(params, inputs, None)
        out["chunk"] = ""
    except ValueError as e:
        out["chunk"] = str(e)
    cfg = registry.get_config("paper-mpfp-100m", smoke=True)
    layout = _ulysses_layout(cfg, 2, 32, "prefill", mesh)
    params = fsdp.shard_tree(T.init_params(cfg), layout.params)
    inputs = {k: _t(v)[layout.rows(2)] for k, v in
              ulysses_inputs(cfg, 2, 32).items() if k != "labels"}
    long_cache = dl.shard_cache(T.make_cache(cfg, 2, 64), layout)
    try:
        make_prefill_step(cfg, pol, layout=layout)(params, inputs,
                                                   long_cache)
        out["long"] = ""
    except NotImplementedError as e:
        out["long"] = str(e)
    return out
