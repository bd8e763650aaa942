"""Zamba2-2.7B — hybrid: Mamba2 backbone + ONE shared attention block invoked
every 6 layers with per-invocation LoRA.
[arXiv:2411.15242; hf]  54L d_model=2560 32H (shared attn) d_ff=10240
ssm_state=64 vocab=32000."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssm import SSMDims

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    vocab=32000,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    head_dim=80,
    ssm=SSMDims(d_model=2560, d_state=64, head_dim=64, expand=2, n_groups=1,
                d_conv=4, chunk=256),
    hybrid_attn_every=6,
    hybrid_lora_rank=128,
    max_seq=524288,
    sub_quadratic=True,   # attention is O(1)-per-step at decode w/ cache;
                          # state cost dominated by Mamba2 -> long_500k runs
    source="[arXiv:2411.15242; hf Zyphra/Zamba2-2.7B]",
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    head_dim=16,
    ssm=SSMDims(d_model=64, d_state=16, head_dim=16, expand=2, n_groups=1,
                d_conv=4, chunk=16),
    hybrid_attn_every=2,
    hybrid_lora_rank=8,
    max_seq=128,
    sub_quadratic=True,
    attn_q_chunk=16,
    attn_kv_chunk=16,
)
