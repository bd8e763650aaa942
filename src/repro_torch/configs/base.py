"""Model configuration (port of ``repro.configs.base``).

The fields are the JAX package's that the dense family reads, under the
same names, so a configuration reads the same in both packages.  The MLA /
MoE / SSM dims stay ``None``: the port runs the dense family only so far
(ROADMAP.md, "Other families"); their other fields, and their terms of
``param_count``, come with them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


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
    mla: Optional[Any] = None   # MLA / MoE / SSM dims: not ported yet
    moe: Optional[Any] = None
    ssm: Optional[Any] = None
    encoder_only: bool = False  # bidirectional attention, no decode
    max_seq: int = 8192
    remat: bool = True          # rematerialize each layer under autograd
    attn_q_chunk: int = 1024    # chunk-scan attention tiles
    attn_kv_chunk: int = 1024
    source: str = ""

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

    def _check_dense(self) -> None:
        if self.family != "dense" or self.mla is not None:
            raise NotImplementedError(
                f"parameter counts of family {self.family!r} are not ported "
                f"yet (ROADMAP.md, 'Other families')")

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D): the dense
        GQA family's embed, layers and untied LM head."""
        self._check_dense()
        d, L, V = self.d_model, self.n_layers, self.vocab
        dh = self.resolved_head_dim
        per_layer = (d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
                     + self.n_heads * dh * d + 3 * d * self.d_ff)
        return V * d + L * per_layer + V * d

    def active_param_count(self) -> int:
        """Activated params per token (every param, in the dense family)."""
        return self.param_count()


def d_eff(cfg: ModelConfig) -> int:
    return cfg.d_model
