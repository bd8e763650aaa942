"""Mistral-Large 123B — dense GQA LM.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]  88L d_model=12288
96H (GQA kv=8) d_ff=28672 vocab=32768, head_dim=128."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    vocab=32768,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    head_dim=128,
    max_seq=32768,
    scan_group=4,
    sub_quadratic=False,
    source="[hf:mistralai/Mistral-Large-Instruct-2407; unverified]",
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    head_dim=8,
    max_seq=128,
    attn_q_chunk=16,
    attn_kv_chunk=16,
)
