"""Model configuration (port of ``repro.configs.base``).

The fields are the JAX package's that the dense family reads, under the
same names, so a configuration reads the same in both packages.  The MLA /
MoE / SSM dims stay ``None``: the port runs the dense family only so far
(ROADMAP.md, "Other families"); their other fields come with them.
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
