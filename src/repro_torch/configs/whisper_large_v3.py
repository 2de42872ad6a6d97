"""whisper-large-v3 [audio] — encoder-decoder transformer backbone; the
conv/mel frontend is a STUB (input_specs() provides precomputed frame
embeddings).  [arXiv:2212.04356; unverified]"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                  # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    act="gelu",
    glu=False,
    norm="layernorm",
    pos="learned",
    enc_dec=True,
    n_enc_layers=32,
    enc_frames=1500,
    tie_embeddings=True,
    subquadratic=False,
    source="arXiv:2212.04356",
)
