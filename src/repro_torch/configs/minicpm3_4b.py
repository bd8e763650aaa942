"""MiniCPM3-4B — dense transformer with MLA.
[hf:openbmb/MiniCPM3-4B; hf]  62L d_model=2560 40H d_ff=6400 vocab=73448,
MLA kv_lora=256 q_lora=768 (per the HF config)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.mla import MLADims

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    vocab=73448,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    mla=MLADims(d_model=2560, n_heads=40, kv_lora=256, q_lora=768,
                qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
    max_seq=32768,
    scan_group=2,
    sub_quadratic=False,
    source="[hf:openbmb/MiniCPM3-4B; hf]",
)

SMOKE = ModelConfig(
    name="minicpm3-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    mla=MLADims(d_model=64, n_heads=4, kv_lora=32, q_lora=48,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    max_seq=128,
    attn_q_chunk=16,
    attn_kv_chunk=16,
)
