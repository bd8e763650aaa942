"""The dense transformer (port of the dense family of
``repro.models.transformer``): parameter init, forward, and the dense and
paged KV caches.  Layers run as a Python loop over a list of per-layer
parameter dicts (the JAX package scans stacked ``(L, ...)`` leaves; see
``repro_torch.weights.params_from_jax``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import AttnDims, KVCache
from repro_torch.models.layers import (dense_init, embed, embed_init,
                                       rms_norm, swiglu_mlp, unembed)
from repro_torch.serve.kv_cache import PagedKVCache


def _attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        rope_fraction=cfg.rope_fraction, causal=not cfg.encoder_only)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.mla is not None:
        raise NotImplementedError(
            f"the port runs the dense GQA family only so far (family="
            f"{cfg.family!r}); see ROADMAP.md 'Other families'")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` (the JAX
    package's init scales; not its numbers — use ``params_from_jax`` to run
    the same weights in both packages)."""
    _check_dense(cfg)
    gen = torch.Generator().manual_seed(seed)
    d, ff = cfg.d_model, cfg.d_ff
    params: Dict[str, object] = {
        "embed": {"table": embed_init(gen, cfg.padded_vocab, d, device)}}
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn": attn_lib.init_attn_params(gen, _attn_dims(cfg), device),
            "mlp": {"w_gate": dense_init(gen, d, ff, device=device),
                    "w_up": dense_init(gen, d, ff, device=device),
                    "w_down": dense_init(gen, ff, d, device=device)},
            "ln1": {"w": torch.ones(d, device=device)},
            "ln2": {"w": torch.ones(d, device=device)},
        })
    params["layers"] = layers
    params["ln_final"] = {"w": torch.ones(d, device=device)}
    params["lm_head"] = {"w": dense_init(gen, d, cfg.padded_vocab,
                                         device=device)}
    return params


@dataclasses.dataclass
class ModelCache:
    """Per-layer KV caches: dense :class:`KVCache` objects, or per-layer
    :class:`PagedKVCache` views of one paged pool (see
    :func:`paged_cache`)."""
    attn: List

    @property
    def length(self):
        """The valid prefix: an int (dense), or the per-slot (B,) lengths
        (paged)."""
        return self.attn[0].length


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
    _check_dense(cfg)
    dims = _attn_dims(cfg)
    return ModelCache([attn_lib.make_kv_cache(batch, max_seq, dims, dtype,
                                              device)
                       for _ in range(cfg.n_layers)])


def _dense_layer_fwd(lp: dict, h: torch.Tensor, cfg: ModelConfig,
                     policy: PrecisionPolicy, positions: torch.Tensor,
                     cache: Optional[KVCache]):
    a_in = rms_norm(h, lp["ln1"]["w"], cfg.norm_eps)
    a_out, new_cache = attn_lib.gqa_forward(
        lp["attn"], a_in, _attn_dims(cfg), policy, positions=positions,
        cache=cache, q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    h = h + a_out
    m_in = rms_norm(h, lp["ln2"]["w"], cfg.norm_eps)
    m = lp["mlp"]
    h = h + swiglu_mlp(m_in, m["w_gate"], m["w_up"], m["w_down"], policy)
    return h, new_cache


def forward(params: dict, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
            policy: PrecisionPolicy, *, cache: Optional[ModelCache] = None
            ) -> Tuple[torch.Tensor, Optional[ModelCache]]:
    """Returns (logits (B, S, vocab), updated cache or None).
    ``inputs``: {"tokens": (B, S) int}."""
    _check_dense(cfg)
    h = embed(inputs["tokens"], params["embed"]["table"])
    B, S, _ = h.shape
    base = cache.length if cache is not None else 0
    if torch.is_tensor(base) and base.ndim:  # paged: per-slot (B,) lengths
        base = base[:, None]
    positions = (base + torch.arange(S, device=h.device)[None, :]).expand(
        B, S)
    new_caches = []
    for i, lp in enumerate(params["layers"]):
        lc = cache.attn[i] if cache is not None else None
        h, nc = _dense_layer_fwd(lp, h, cfg, policy, positions, lc)
        new_caches.append(nc)
    h = rms_norm(h, params["ln_final"]["w"], cfg.norm_eps)
    logits = unembed(h, params["lm_head"]["w"], policy)
    if cfg.padded_vocab != cfg.vocab:
        logits = logits[..., :cfg.vocab]
    return logits, (ModelCache(new_caches) if cache is not None else None)
