"""LLaVA-NeXT 34B — VLM: dense LM backbone (Yi-34B class) + anyres vision
frontend (STUB per spec: input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  60L d_model=7168
56H (GQA kv=8) d_ff=20480 vocab=64000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    vocab=64000,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    head_dim=128,
    frontend="vision",
    n_patches=576,       # one 24x24 anyres tile of precomputed embeddings
    max_seq=32768,
    scan_group=4,
    sub_quadratic=False,
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf (34b variant); unverified]",
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    head_dim=16,
    frontend="vision",
    n_patches=8,
    max_seq=128,
    attn_q_chunk=16,
    attn_kv_chunk=16,
)
