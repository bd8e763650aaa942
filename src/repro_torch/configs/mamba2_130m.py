"""Mamba2-130M — attention-free SSM (SSD / state-space duality).
[arXiv:2405.21060; unverified]  24L d_model=768 d_inner=1536 (expand 2)
head_dim=64 ssm_state=128 vocab=50280."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssm import SSMDims

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab=50280,
    ssm=SSMDims(d_model=768, d_state=128, head_dim=64, expand=2, n_groups=1,
                d_conv=4, chunk=256),
    max_seq=524288,
    sub_quadratic=True,   # O(1)-state decode: runs the long_500k cell
    source="[arXiv:2405.21060; unverified]",
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    vocab=256,
    ssm=SSMDims(d_model=64, d_state=16, head_dim=16, expand=2, n_groups=1,
                d_conv=4, chunk=16),
    max_seq=128,
    sub_quadratic=True,
)
