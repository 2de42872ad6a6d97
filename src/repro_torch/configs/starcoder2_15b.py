"""starcoder2-15b [dense] — GQA kv=4, RoPE, sliding-window 4096.
[arXiv:2402.19173; hf]"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    act="gelu",
    glu=False,                    # starcoder2 uses a plain (non-gated) MLP
    norm="layernorm",
    pos="rope",
    qkv_bias=True,
    window=4096,                  # sliding-window attention
    subquadratic=True,            # windowed KV -> long_500k decode runnable
    source="arXiv:2402.19173",
)
