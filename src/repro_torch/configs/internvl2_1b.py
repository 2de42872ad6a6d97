"""internvl2-1b [vlm] — InternViT frontend STUB (precomputed patch
embeddings via input_specs()) + InternLM2-1B language backbone.
[arXiv:2404.16821; hf]"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    act="silu",
    glu=True,
    norm="rmsnorm",
    pos="rope",
    n_patches=256,                # vision prefix tokens (stub frontend)
    tie_embeddings=True,
    subquadratic=False,
    source="arXiv:2404.16821",
)
