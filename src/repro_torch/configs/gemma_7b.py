"""gemma-7b [dense] — GeGLU, head_dim=256, MHA-as-GQA(kv=16).
[arXiv:2403.08295; hf]"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    head_dim=256,
    act="geglu",
    glu=True,
    norm="rmsnorm",
    pos="rope",
    tie_embeddings=True,          # gemma ties input/output embeddings
    subquadratic=False,
    source="arXiv:2403.08295",
)
