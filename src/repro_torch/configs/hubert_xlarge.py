"""HuBERT X-Large — encoder-only audio transformer (w2v2 architecture).
Frontend (conv feature extractor) is a STUB per spec: input_specs provides
precomputed frame embeddings at d_model.  Training target = frame-level
cluster ids (vocab=504), i.e. masked-prediction cross-entropy.
[arXiv:2106.07447; unverified]  48L d_model=1280 16H d_ff=5120 vocab=504."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    vocab=504,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    encoder_only=True,
    frontend="audio",
    rope_theta=0.0,      # w2v2 uses conv positional embeddings (stubbed);
                         # rope disabled for fidelity to the encoder arch
    max_seq=32768,
    scan_group=4,
    sub_quadratic=False,
    source="[arXiv:2106.07447; unverified]",
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    vocab=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    encoder_only=True,
    frontend="audio",
    rope_theta=0.0,
    max_seq=128,
    attn_q_chunk=16,
    attn_kv_chunk=16,
)
