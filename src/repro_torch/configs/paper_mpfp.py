"""The paper's own benchmark vehicle: a ~100M-parameter dense LM (port of
``repro.configs.paper_mpfp``; the same numbers)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-mpfp-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    vocab=32000,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    max_seq=2048,
)

SMOKE = ModelConfig(
    name="paper-mpfp-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    max_seq=128,
    attn_q_chunk=16,
    attn_kv_chunk=16,
)
