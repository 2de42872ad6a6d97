"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""

from .base import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    act="silu",
    glu=True,
    norm="rmsnorm",
    pos="rope",
    moe=MoEConfig(num_experts=8, top_k=2),
    window=4096,                  # SWA per the assignment
    subquadratic=True,
    source="arXiv:2401.04088",
)
