"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern,
MQA (kv=1), window 2048.  [arXiv:2402.19427; unverified]"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    act="geglu",
    glu=True,
    norm="rmsnorm",
    pos="rope",
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048,
    tie_embeddings=True,
    subquadratic=True,            # constant RG-LRU state + windowed attn
    source="arXiv:2402.19427",
)
