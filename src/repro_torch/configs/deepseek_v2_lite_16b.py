"""DeepSeek-V2-Lite 16B — MoE + MLA (no query compression in Lite).
[arXiv:2405.04434; hf]  27L d_model=2048 16H d_ff(expert)=1408 vocab=102400,
64 routed experts top-6 + 2 shared, MLA kv_lora=512."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.mla import MLADims
from repro_torch.models.moe import MoEDims

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    vocab=102400,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    mla=MLADims(d_model=2048, n_heads=16, kv_lora=512, q_lora=0,
                qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEDims(d_model=2048, n_experts=64, top_k=6, expert_ff=1408,
                n_shared=2, capacity_factor=1.25, n_chunks=2),
    first_k_dense=1,
    dense_ff=10944,
    max_seq=32768,
    sub_quadratic=False,
    source="[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite]",
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-16b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    mla=MLADims(d_model=64, n_heads=4, kv_lora=32, q_lora=0,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoEDims(d_model=64, n_experts=4, top_k=2, expert_ff=96, n_shared=2,
                capacity_factor=2.0),
    first_k_dense=1,
    dense_ff=128,
    max_seq=128,
    attn_q_chunk=16,
    attn_kv_chunk=16,
)
