"""moonshot-v1-16b-a3b [moe] — 64 experts top-6 (kimi/moonlight),
expert d_ff=1408.  [hf:moonshotai/Moonlight-16B-A3B; hf]"""

from .base import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    act="silu",
    glu=True,
    norm="rmsnorm",
    pos="rope",
    moe=MoEConfig(num_experts=64, top_k=6),
    subquadratic=False,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
