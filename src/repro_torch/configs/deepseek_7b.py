"""DeepSeek-7B — dense llama-architecture LM.
[arXiv:2401.02954; hf]  30L d_model=4096 32H (MHA kv=32) d_ff=11008
vocab=102400."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    vocab=102400,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    max_seq=32768,
    scan_group=2,
    sub_quadratic=False,
    source="[arXiv:2401.02954; hf deepseek-ai/deepseek-llm-7b-base]",
)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke",
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
