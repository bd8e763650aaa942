"""Unified model configuration covering every architecture family (port of
``repro.configs.base``: the fields the port reads, under the same names
and with the same values, so a configuration reads the same in both
packages)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.mla import MLADims
from repro_torch.models.moe import MoEDims
from repro_torch.models.ssm import SSMDims


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0           # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # chatglm3: 0.5 ("RoPE 2d")
    norm_eps: float = 1e-6
    mla: Optional[MLADims] = None
    moe: Optional[MoEDims] = None
    ssm: Optional[SSMDims] = None
    first_k_dense: int = 0      # MoE: first k layers keep a dense FFN
    dense_ff: int = 0           # ... of this width
    hybrid_attn_every: int = 0  # zamba2: shared attn block every k layers
    hybrid_lora_rank: int = 0   # zamba2: per-invocation LoRA on shared attn
    encoder_only: bool = False  # hubert: bidirectional, no decode
    frontend: str = "none"      # none | vision | audio (stub per spec)
    n_patches: int = 0          # vlm: patch embeddings per image
    max_seq: int = 8192
    remat: bool = True          # rematerialize each layer under autograd
    scan_layers: bool = True    # False: the JAX package's unrolled loop
    scan_group: int = 1         # remat one GROUP of layers as one region
    attn_q_chunk: int = 1024    # chunk-scan attention tiles
    attn_kv_chunk: int = 1024
    sub_quadratic: bool = False  # eligible for long_500k
    source: str = ""            # provenance: [paper/hf; tier]

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 256 multiple (the JAX package's embed and
        lm_head width); logits are sliced back to ``vocab`` in forward()."""
        return (self.vocab + 255) // 256 * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D), the JAX
        package's formula term for term."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        total = V * d  # embed
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            dh = self.resolved_head_dim
            if self.mla is not None:
                m = self.mla
                q = (d * m.q_lora + m.q_lora * self.n_heads * m.qk_head_dim
                     if m.q_lora else d * self.n_heads * m.qk_head_dim)
                per_layer += (q + d * m.kv_lora + d * m.qk_rope_dim
                              + m.kv_lora * self.n_heads *
                              (m.qk_nope_dim + m.v_head_dim)
                              + self.n_heads * m.v_head_dim * d)
            else:
                per_layer += (d * self.n_heads * dh
                              + 2 * d * self.n_kv_heads * dh
                              + self.n_heads * dh * d)
        if self.family == "moe":
            mo = self.moe
            moe_layer = (d * mo.n_experts
                         + 3 * mo.n_experts * d * mo.expert_ff
                         + (3 * d * mo.shared_ff_dim if mo.n_shared else 0))
            dense_layer = 3 * d * (self.dense_ff or self.d_ff)
            total += (self.first_k_dense * (per_layer + dense_layer)
                      + (L - self.first_k_dense) * (per_layer + moe_layer))
        elif self.family in ("dense", "vlm", "audio"):
            per_layer += 3 * d * self.d_ff
            total += L * per_layer
        elif self.family == "ssm":
            s = self.ssm
            per_layer = (d * s.in_proj_dim + s.d_conv * s.conv_dim
                         + s.d_inner * d)
            total += L * per_layer
        elif self.family == "hybrid":
            s = self.ssm
            mamba_layer = (d * s.in_proj_dim + s.d_conv * s.conv_dim
                           + s.d_inner * d)
            dh = self.resolved_head_dim
            shared_attn = (d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
                           + self.n_heads * dh * d + 3 * d * self.d_ff)
            n_groups = L // max(1, self.hybrid_attn_every)
            lora = (4 * n_groups * self.hybrid_lora_rank * (d + self.n_heads * dh)
                    if self.hybrid_lora_rank else 0)
            total += L * mamba_layer + shared_attn + lora
        total += V * d  # lm head (untied)
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        mo = self.moe
        full = self.param_count()
        inactive = ((self.n_layers - self.first_k_dense) * 3 * d_eff(self)
                    * mo.expert_ff * (mo.n_experts - mo.top_k))
        return full - inactive


def d_eff(cfg: ModelConfig) -> int:
    return cfg.d_model
