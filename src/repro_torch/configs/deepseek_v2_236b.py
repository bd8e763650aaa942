"""DeepSeek-V2 236B — MoE with Multi-head Latent Attention.
[arXiv:2405.04434; hf]  60L d_model=5120 128H d_ff(expert)=1536 vocab=102400,
160 routed experts top-6 + 2 shared, MLA kv_lora=512."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.mla import MLADims
from repro_torch.models.moe import MoEDims

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    vocab=102400,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    mla=MLADims(d_model=5120, n_heads=128, kv_lora=512, q_lora=1536,
                qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEDims(d_model=5120, n_experts=160, top_k=6, expert_ff=1536,
                n_shared=2, capacity_factor=1.25, n_chunks=4,
                dispatch_dtype="float32"),
    first_k_dense=1,
    dense_ff=12288,
    max_seq=32768,
    sub_quadratic=False,
    source="[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2]",
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    mla=MLADims(d_model=64, n_heads=4, kv_lora=32, q_lora=48,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoEDims(d_model=64, n_experts=8, top_k=2, expert_ff=96,
                n_shared=2, capacity_factor=2.0),
    first_k_dense=1,
    dense_ff=128,
    max_seq=128,
    attn_q_chunk=16,
    attn_kv_chunk=16,
)
