"""gpt2-medium — the paper's own LLM workload (§VIII-C, Table VI).
[hf:openai-community/gpt2-medium]"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="gpt2-medium",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=50257,
    act="gelu",
    glu=False,
    norm="layernorm",
    pos="learned",
    tie_embeddings=True,
    subquadratic=False,
    source="hf:openai-community/gpt2-medium",
)
