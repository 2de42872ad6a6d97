"""mamba2-780m [ssm] — SSD (state-space duality), attention-free,
ssm_state=128.  [arXiv:2405.21060; unverified]"""

from .base import ArchConfig, SSMConfig

ARCH = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    norm="rmsnorm",
    pos="none",
    block_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256, conv_width=4),
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2405.21060",
)
