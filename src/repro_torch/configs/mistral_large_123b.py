"""mistral-large-123b [dense] — GQA kv=8, full attention.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    head_dim=128,
    act="silu",
    glu=True,
    norm="rmsnorm",
    pos="rope",
    subquadratic=False,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
