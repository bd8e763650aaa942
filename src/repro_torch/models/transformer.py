"""The unified model stack (port of ``repro.models.transformer``): parameter
init, forward and caches of every family.

  dense   — GQA or MLA attention + SwiGLU MLP (llama/mistral/chatglm/minicpm3)
  moe     — attention + (shared + routed experts) FFN  (deepseek-v2/-lite)
  ssm     — Mamba2 SSD mixer only                      (mamba2-130m)
  hybrid  — Mamba2 layers + ONE shared attention block invoked every
            ``hybrid_attn_every`` layers with per-invocation LoRA (zamba2)
  vlm     — dense backbone; precomputed patch embeddings prepended (llava)
  audio   — encoder-only bidirectional; frame embeddings in, frame-level
            cluster logits out (hubert)

Layers run as a Python loop over lists of per-layer parameter dicts (the
JAX package scans stacked ``(L, ...)`` leaves; see
``repro_torch.weights.params_from_jax``).  Under autograd with
``cfg.remat`` every layer is rematerialized (the JAX package's
``jax.checkpoint``): its forward runs again in the backward — a dense,
MoE or Mamba2 layer alone, or ``cfg.scan_group`` of them together (JAX's
nested scan), and each zamba2 group (the shared block with its LoRA, then
its Mamba2 layers) as one region.  ``cfg.scan_layers=False`` is the JAX
package's unrolled loop, which does not rematerialize.

Under an FSDP layout (``dist.fsdp.use_layout``; the training step installs
it) the parameters are this rank's blocks: the forward gathers each
layer's leaves right before the layer runs — again in remat's recompute —
and the embedding, the hybrid's shared block, the final norm and the head
where it first uses them (``dist.fsdp.gatherer``).  With no layout the
hook is the identity.

Under a decode layout (``dist.decode_layout.use_decode_layout``; the serve
step installs it) the forward runs on this rank's rows, the parameters
through the same hook (blocks under pure FSDP rules, whole at batch 1),
each attention layer (the hybrid's shared block too) over this rank's
block of its cache sequence, each Mamba2 layer on its rows of the
state.

Under the Ulysses layout (``dist.seq_layout.use_seq_layout``; the train
and prefill steps install it) the inputs are this rank's rows with the
whole sequence: the forward embeds them (the VLM's patches first) and
keeps the rank's block of the sequence, positions at its offset; the
parameters come through the same hook (FSDP blocks over the batch axes);
each attention layer takes the layout's heads or seq mode, each Mamba2
layer its block after the previous block's (``models.ssm``), and remat's
recompute runs under the layout again."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import auto as auto_lib
from repro_torch.core import dispatch as dispatch_lib
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import decode_layout as decode_layout_lib
from repro_torch.dist import fsdp as fsdp_lib
from repro_torch.dist import seq_layout as seq_layout_lib
from repro_torch.dist import sharding as sharding_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import AttnDims
from repro_torch.models.layers import (dense_init, embed, embed_init,
                                       make_generator, rms_norm, swiglu_mlp,
                                       unembed)
from repro_torch.serve.kv_cache import PagedKVCache


def _attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        rope_fraction=cfg.rope_fraction, causal=not cfg.encoder_only)


def _init_attn(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    if cfg.mla is not None:
        return {"mla": mla_lib.init_mla_params(gen, cfg.mla, device)}
    return {"attn": attn_lib.init_attn_params(gen, _attn_dims(cfg), device)}


def _init_dense_layer(gen: torch.Generator, cfg: ModelConfig, ff: int,
                      device) -> dict:
    d = cfg.d_model
    return {
        **_init_attn(gen, cfg, device),
        "mlp": {"w_gate": dense_init(gen, d, ff, device=device),
                "w_up": dense_init(gen, d, ff, device=device),
                "w_down": dense_init(gen, ff, d, device=device)},
        "ln1": {"w": torch.ones(d, device=device)},
        "ln2": {"w": torch.ones(d, device=device)},
    }


def _init_moe_layer(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    return {**_init_attn(gen, cfg, device),
            "moe": moe_lib.init_moe_params(gen, cfg.moe, device),
            "ln1": {"w": torch.ones(d, device=device)},
            "ln2": {"w": torch.ones(d, device=device)}}


def _init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    return {"ssm": ssm_lib.init_ssm_params(gen, cfg.ssm, device),
            "ln1": {"w": torch.ones(cfg.d_model, device=device)}}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the JAX package's init scales; not its numbers — use
    ``params_from_jax`` to run the same weights in both packages).  Layers
    are lists of per-layer dicts: ``layers`` (and the MoE family's
    ``dense_layers``); the hybrid's are its L Mamba2 layers in order, with
    ONE ``shared_block`` and a ``shared_lora`` per group."""
    gen = make_generator(seed, device)
    d, L = cfg.d_model, cfg.n_layers
    params: Dict[str, object] = {}
    if cfg.family != "audio":
        params["embed"] = {"table": embed_init(gen, cfg.padded_vocab, d,
                                               device)}
    if cfg.family in ("dense", "vlm", "audio"):
        params["layers"] = [_init_dense_layer(gen, cfg, cfg.d_ff, device)
                            for _ in range(L)]
    elif cfg.family == "moe":
        if cfg.first_k_dense:
            params["dense_layers"] = [
                _init_dense_layer(gen, cfg, cfg.dense_ff or cfg.d_ff, device)
                for _ in range(cfg.first_k_dense)]
        params["layers"] = [_init_moe_layer(gen, cfg, device)
                            for _ in range(L - cfg.first_k_dense)]
    elif cfg.family == "ssm":
        params["layers"] = [_init_ssm_layer(gen, cfg, device)
                            for _ in range(L)]
    elif cfg.family == "hybrid":
        params["layers"] = [_init_ssm_layer(gen, cfg, device)
                            for _ in range(L)]
        params["shared_block"] = _init_dense_layer(gen, cfg, cfg.d_ff, device)
        if cfg.hybrid_lora_rank:
            r, dq = cfg.hybrid_lora_rank, cfg.n_heads * cfg.resolved_head_dim

            def pair(d_out):
                return {"a": dense_init(gen, d, r, scale=0.01, device=device),
                        "b": torch.zeros((r, d_out), device=device)}

            n_groups = L // cfg.hybrid_attn_every
            params["shared_lora"] = [{"q": pair(dq), "o": pair(d)}
                                     for _ in range(n_groups)]
    else:
        raise ValueError(cfg.family)
    params["ln_final"] = {"w": torch.ones(d, device=device)}
    head = "ctc_head" if cfg.family == "audio" else "lm_head"
    params[head] = {"w": dense_init(gen, d, cfg.padded_vocab, device=device)}
    return params


@dataclasses.dataclass
class ModelCache:
    """Per-layer caches of each family; fields a family does not use are
    None.  ``attn``: dense :class:`KVCache`, :class:`MLACache` or per-layer
    :class:`PagedKVCache` views of one paged pool (see :func:`paged_cache`);
    ``dense_attn``: the MoE family's first-k dense layers; ``ssm``: one
    :class:`SSMCache` per Mamba2 layer; ``shared_attn``: the hybrid's
    :class:`KVCache` per group of its shared block."""
    attn: Optional[List] = None
    dense_attn: Optional[List] = None
    ssm: Optional[List] = None
    shared_attn: Optional[List] = None

    @property
    def length(self):
        """The valid prefix: an int (dense), or the per-slot (B,) lengths
        (paged)."""
        for c in (self.attn, self.ssm, self.shared_attn, self.dense_attn):
            if c:
                return c[0].length
        raise ValueError("empty cache")


def paged_cache(pool_k: torch.Tensor, pool_v: torch.Tensor,
                block_table: torch.Tensor, lengths: torch.Tensor
                ) -> ModelCache:
    """The per-layer views of a paged pool (L, n_blocks, bs, Hkv, Dh) for one
    step: layer ``l`` reads and writes ``pool_k[l]`` / ``pool_v[l]`` in
    place; every layer shares the micro-batch's (B, W) table and (B,)
    lengths (int32, on the pool's device)."""
    return ModelCache([PagedKVCache(pool_k[l], pool_v[l], block_table,
                                    lengths)
                       for l in range(pool_k.shape[0])])


def make_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> ModelCache:
    if cfg.encoder_only:
        raise ValueError("encoder-only archs have no decode cache")

    def attn_caches(n):
        if cfg.mla is not None:
            return [mla_lib.make_mla_cache(batch, max_seq, cfg.mla, dtype,
                                           device) for _ in range(n)]
        return [attn_lib.make_kv_cache(batch, max_seq, _attn_dims(cfg),
                                       dtype, device) for _ in range(n)]

    def ssm_caches(n):
        return [ssm_lib.make_ssm_cache(batch, cfg.ssm, torch.float32, device)
                for _ in range(n)]

    if cfg.family in ("dense", "vlm"):
        return ModelCache(attn=attn_caches(cfg.n_layers))
    if cfg.family == "moe":
        return ModelCache(
            attn=attn_caches(cfg.n_layers - cfg.first_k_dense),
            dense_attn=(attn_caches(cfg.first_k_dense)
                        if cfg.first_k_dense else None))
    if cfg.family == "ssm":
        return ModelCache(ssm=ssm_caches(cfg.n_layers))
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.hybrid_attn_every
        mk = lambda: attn_lib.make_kv_cache(batch, max_seq, _attn_dims(cfg),
                                            dtype, device)
        return ModelCache(ssm=ssm_caches(cfg.n_layers),
                          shared_attn=[mk() for _ in range(n_groups)])
    raise ValueError(cfg.family)


def _attn_block(lp: dict, h: torch.Tensor, cfg: ModelConfig,
                policy: PrecisionPolicy, positions: torch.Tensor, cache,
                lora: Optional[dict] = None):
    if cfg.mla is not None:
        return mla_lib.mla_forward(
            lp["mla"], h, cfg.mla, policy, positions=positions, cache=cache,
            q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    p = lp["attn"]
    if lora is not None:  # zamba2's per-invocation LoRA on shared weights
        p = dict(p)
        p["wq"] = p["wq"] + lora["q"]["a"] @ lora["q"]["b"]
        p["wo"] = p["wo"] + lora["o"]["a"] @ lora["o"]["b"]
    return attn_lib.gqa_forward(
        p, h, _attn_dims(cfg), policy, positions=positions, cache=cache,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)


def _dense_layer_fwd(lp: dict, h: torch.Tensor, cfg: ModelConfig,
                     policy: PrecisionPolicy, positions: torch.Tensor,
                     cache):
    a_in = rms_norm(h, lp["ln1"]["w"], cfg.norm_eps)
    a_out, new_cache = _attn_block(lp, a_in, cfg, policy, positions, cache)
    h = h + a_out
    m_in = rms_norm(h, lp["ln2"]["w"], cfg.norm_eps)
    m = lp["mlp"]
    h = h + swiglu_mlp(m_in, m["w_gate"], m["w_up"], m["w_down"], policy)
    return h, new_cache


def _moe_layer_fwd(lp: dict, h: torch.Tensor, cfg: ModelConfig,
                   policy: PrecisionPolicy, positions: torch.Tensor, cache,
                   mesh, moe_kw: Optional[dict] = None):
    """``moe_kw``: the expert-parallel layout arguments
    (``dist.sharding.moe_layer_kwargs``), taken where the forward starts:
    remat's recompute runs on autograd's thread, which sees no rules."""
    a_in = rms_norm(h, lp["ln1"]["w"], cfg.norm_eps)
    a_out, new_cache = _attn_block(lp, a_in, cfg, policy, positions, cache)
    h = h + a_out
    m_in = rms_norm(h, lp["ln2"]["w"], cfg.norm_eps)
    moe_out, aux = moe_lib.moe_forward(lp["moe"], m_in, cfg.moe, policy,
                                       mesh=mesh, **(moe_kw or {}))
    return h + moe_out, new_cache, aux


def _ssm_layer_fwd(lp: dict, h: torch.Tensor, cfg: ModelConfig,
                   policy: PrecisionPolicy, cache):
    s_in = rms_norm(h, lp["ln1"]["w"], cfg.norm_eps)
    s_out, new_cache = ssm_lib.ssm_forward(lp["ssm"], s_in, cfg.ssm, policy,
                                           cache=cache)
    return h + s_out, new_cache


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): only
    its inputs are kept, and it runs again when the backward reaches it,
    under the precision context of the first run (the recompute runs on
    the autograd engine's thread).  AUTO calls analyze their operands
    again in the recompute and each must select what the forward selected
    (:class:`~repro_torch.core.auto.SelectionLog`); each MoE router must
    pick the experts it picked (:class:`~repro_torch.models.moe.RouteLog`),
    or the backward raises."""
    snap = dispatch_lib.snapshot()
    selections = auto_lib.SelectionLog()
    routes = moe_lib.RouteLog()
    seq = seq_layout_lib.current_seq_layout()

    @contextlib.contextmanager
    def record():
        with selections.recording(), routes.recording():
            yield

    @contextlib.contextmanager
    def recompute():
        with dispatch_lib.restored(snap), selections.replaying(), \
                routes.replaying(), seq_layout_lib.use_seq_layout(seq):
            yield

    # under the Ulysses layout the recompute runs the region's exchanges
    # again, which every rank of the group must meet: it runs whole (no
    # early stop at the last saved tensor)
    with (contextlib.nullcontext() if seq is None else
          torch.utils.checkpoint.set_checkpoint_early_stop(False)):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: (record(), recompute()))


def _needs_grad(h: torch.Tensor, layers) -> bool:
    return torch.is_grad_enabled() and (h.requires_grad or any(
        w.requires_grad for w in tree_lib.leaves(layers)))


def _stack(layers: List[dict], h: torch.Tensor, aux: torch.Tensor,
           cfg: ModelConfig, caches: Optional[List], step, pre=None):
    """Run ``step(lp, h, cache) -> (h, new cache, aux (2,) or None)`` over
    the layers in order, adding their aux values to ``aux`` in layer order
    (JAX's ``_scan_layers``).  Under autograd with ``cfg.remat`` (and
    ``cfg.scan_layers``) each layer — or each group of ``cfg.scan_group``
    layers where that divides the stack, JAX's nested scan — is one
    rematerialized region.  ``pre(i, lp)`` (the FSDP gather) runs right
    before layer ``i``, inside its region."""
    n = len(layers)
    pre = pre or (lambda i, lp: lp)
    if not (cfg.remat and cfg.scan_layers and caches is None
            and _needs_grad(h, layers)):
        new_caches = []
        for i, lp in enumerate(layers):
            h, nc, a = step(pre(i, lp), h,
                            caches[i] if caches is not None else None)
            if a is not None:
                aux = aux + a
            new_caches.append(nc)
        return h, aux, new_caches
    g = max(1, cfg.scan_group)
    g = g if g > 1 and n % g == 0 and n > g else 1

    def region(s):
        def body(h, aux):
            for i in range(s, s + g):
                h, _, a = step(pre(i, layers[i]), h, None)
                if a is not None:
                    aux = aux + a
            return h, aux

        return body

    for s in range(0, n, g):
        h, aux = _remat(region(s), h, aux)
    return h, aux, []


def forward(params: dict, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
            policy: PrecisionPolicy, *, cache: Optional[ModelCache] = None,
            mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                       Optional[ModelCache]]:
    """Returns (logits (B, S, vocab), aux losses, updated cache or None).

    ``inputs``: {"tokens": (B, S) int} and/or {"embeds": (B, S, D)} (audio),
    and optionally {"patch_embeds": (B, P, D)} (vlm), prepended to the
    token embeddings.  ``mesh`` is the MoE family's expert-parallel mesh
    (``models.moe.moe_forward_ep``, laid out by the installed sharding
    rules); the other families take and ignore it.  The aux losses are
    ``{"moe_aux", "moe_zloss"}``, the MoE layers' summed in layer order
    (zeros for the other families)."""
    gather = fsdp_lib.gatherer()
    seq = seq_layout_lib.current_seq_layout()
    if seq is not None and cfg.family == "moe":
        raise NotImplementedError(
            "the MoE family under the Ulysses layout: its experts' layout "
            "beside the sequence blocks (moe_forward_ep) is the MoE under a "
            "layout, ROADMAP.md Queue 1 item 2d, not ported; its train and "
            "prefill cells run whole-rank")
    if (decode_layout_lib.current_decode_layout() is not None
            and cfg.family == "moe"):
        raise NotImplementedError(
            "the MoE family under a decode layout: its experts' layout "
            "beside the rows' (moe_forward_ep) is the MoE under a layout, "
            "ROADMAP.md Queue 1 item 2d, not ported; its decode cells run "
            "whole-rank")
    if fsdp_lib.current_layout() is not None and cfg.family == "moe":
        raise NotImplementedError(
            "the MoE family under an FSDP layout: its router statistics "
            "(the load-balance aux's expert fractions and mean "
            "probabilities) need a global reduction over the batch group, "
            "which the port does not have; a per-rank aux would differ "
            "from the JAX step's")
    if "tokens" in inputs:
        h = embed(inputs["tokens"], gather(params["embed"], "embed")["table"])
        if "patch_embeds" in inputs and cfg.family == "vlm":
            h = torch.cat([inputs["patch_embeds"].to(h.dtype), h], dim=1)
    else:
        h = inputs["embeds"]
    B, S, _ = h.shape
    base = cache.length if cache is not None else 0
    if torch.is_tensor(base) and base.ndim:  # paged: per-slot (B,) lengths
        base = base[:, None]
    if seq is not None:   # this rank's block of the whole sequence
        if S != seq.seq_len:
            raise ValueError(f"the Ulysses layout is of {seq.seq_len} "
                             f"positions; the inputs hold {S}")
        off, S = seq.block
        h = h[:, off:off + S].contiguous()
        base = base + off
    positions = (base + torch.arange(S, device=h.device)[None, :]).expand(
        B, S)
    has_cache = cache is not None
    new_cache = None
    aux = torch.zeros(2, device=h.device)

    def dense_step(lp, h, lc):
        h, nc = _dense_layer_fwd(lp, h, cfg, policy, positions, lc)
        return h, nc, None

    def layer(key):
        return lambda i, lp: gather(lp, key, i)

    if cfg.family in ("dense", "vlm", "audio"):
        h, aux, nc = _stack(params["layers"], h, aux, cfg,
                            cache.attn if has_cache else None, dense_step,
                            layer("layers"))
        new_cache = ModelCache(nc) if has_cache else None
    elif cfg.family == "moe":
        moe_kw = sharding_lib.moe_layer_kwargs() if mesh is not None else None

        def moe_step(lp, h, lc):
            h, nc, a = _moe_layer_fwd(lp, h, cfg, policy, positions, lc,
                                      mesh, moe_kw)
            return h, nc, torch.stack([a["moe_aux"], a["moe_zloss"]])

        nc_dense = None
        if cfg.first_k_dense:
            h, _, nc_dense = _stack(
                params["dense_layers"], h, aux, cfg,
                cache.dense_attn if has_cache else None, dense_step)
        h, aux, nc = _stack(params["layers"], h, aux, cfg,
                            cache.attn if has_cache else None, moe_step)
        if has_cache:
            new_cache = ModelCache(attn=nc, dense_attn=nc_dense)
    elif cfg.family == "ssm":
        def ssm_step(lp, h, lc):
            h, nc = _ssm_layer_fwd(lp, h, cfg, policy, lc)
            return h, nc, None

        h, aux, nc = _stack(params["layers"], h, aux, cfg,
                            cache.ssm if has_cache else None, ssm_step,
                            layer("layers"))
        if has_cache:
            new_cache = ModelCache(ssm=nc)
    elif cfg.family == "hybrid":
        h, new_cache = _hybrid_forward(params, h, cfg, policy, positions,
                                       cache, gather)
    else:
        raise ValueError(cfg.family)
    h = rms_norm(h, gather(params["ln_final"], "ln_final")["w"], cfg.norm_eps)
    head = "ctc_head" if cfg.family == "audio" else "lm_head"
    logits = unembed(h, gather(params[head], head)["w"], policy)
    if cfg.padded_vocab != cfg.vocab:
        logits = logits[..., :cfg.vocab]
    return logits, {"moe_aux": aux[0], "moe_zloss": aux[1]}, new_cache


def _hybrid_forward(params: dict, h: torch.Tensor, cfg: ModelConfig,
                    policy: PrecisionPolicy, positions: torch.Tensor,
                    cache: Optional[ModelCache], gather):
    """zamba2: per group, the ONE shared attention + MLP block (with this
    group's LoRA on wq / wo) then ``hybrid_attn_every`` Mamba2 layers;
    under autograd with ``cfg.remat`` each group is one rematerialized
    region (JAX: ``jax.checkpoint`` of the group scan's body).  ``gather``
    (the FSDP hook) takes the shared block once, each group's LoRA and
    Mamba2 layers inside the group."""
    shared = gather(params["shared_block"], "shared_block")
    loras = params.get("shared_lora")
    every = cfg.hybrid_attn_every
    has_cache = cache is not None
    new_ssm, new_attn = [], []

    def group(g, h):
        a_in = rms_norm(h, shared["ln1"]["w"], cfg.norm_eps)
        a_out, nac = _attn_block(
            shared, a_in, cfg, policy, positions,
            cache.shared_attn[g] if has_cache else None,
            lora=(gather(loras[g], "shared_lora", g) if loras is not None
                  else None))
        h = h + a_out
        m_in = rms_norm(h, shared["ln2"]["w"], cfg.norm_eps)
        m = shared["mlp"]
        h = h + swiglu_mlp(m_in, m["w_gate"], m["w_up"], m["w_down"], policy)
        ncs = []
        for i in range(g * every, (g + 1) * every):
            h, nc = _ssm_layer_fwd(gather(params["layers"][i], "layers", i),
                                   h, cfg, policy,
                                   cache.ssm[i] if has_cache else None)
            ncs.append(nc)
        return h, nac, ncs

    remat = cfg.remat and not has_cache and _needs_grad(h, params)
    for g in range(cfg.n_layers // every):
        if remat:
            h = _remat(lambda h, g=g: group(g, h)[0], h)
            continue
        h, nac, ncs = group(g, h)
        new_attn.append(nac)
        new_ssm.extend(ncs)
    if has_cache:
        return h, ModelCache(ssm=new_ssm, shared_attn=new_attn)
    return h, None
