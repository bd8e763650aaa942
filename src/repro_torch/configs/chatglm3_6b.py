"""ChatGLM3-6B — dense GQA LM with 2D RoPE (rotary on half the head dim).
[arXiv:2406.12793; hf]  28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    vocab=65024,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    rope_fraction=0.5,   # ChatGLM 2D-RoPE: first half rotary, rest pass-through
    max_seq=32768,
    scan_group=2,
    sub_quadratic=False,
    source="[arXiv:2406.12793; hf THUDM/chatglm3-6b]",
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    rope_fraction=0.5,
    max_seq=128,
    attn_q_chunk=16,
    attn_kv_chunk=16,
)
