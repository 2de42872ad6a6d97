"""Architecture & shape configuration schema.

Every assigned architecture is a single :class:`ArchConfig` in its own
``configs/<id>.py``.  ``smoke()`` derives a reduced same-family config for
CPU tests.  The PyTorch port's copy of the reference's ``configs/``: every
field and every config is the reference's; only the dtype map is torch's
(:attr:`ArchConfig.tdtype`, where the reference has ``jdtype``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Shapes (assigned): every LM-family arch × these four cells.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor for dense (dropless-approx) dispatch
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    act: str = "silu"               # silu | gelu | geglu | relu
    glu: bool = True                # gated FFN (SwiGLU/GeGLU)
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    pos: str = "rope"               # rope | learned | none
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # attention pattern
    window: int = 0                 # 0 = full attention; >0 = sliding window
    subquadratic: bool = False      # True -> long_500k cell is runnable
    # mixture of experts
    moe: MoEConfig | None = None
    # state-space (mamba2)
    ssm: SSMConfig | None = None
    # hybrid block pattern, e.g. ("rglru","rglru","attn"); ("attn",) default
    block_pattern: tuple[str, ...] = ("attn",)
    local_window: int = 2048        # window for hybrid local-attn blocks
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500          # whisper audio frames (post conv-stub)
    # multimodal prefix (internvl)
    n_patches: int = 0              # vision patch tokens prepended (stub frontend)
    # provenance
    source: str = ""
    dtype: str = "bfloat16"

    # --- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab rounded up to a multiple of 256 so the
        vocab dim shards evenly over any mesh axis (standard practice;
        labels never index the pad region)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def tdtype(self):
        """The torch dtype of :attr:`dtype`."""
        import torch
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def attn_params(self) -> int:
        o = self.q_dim * self.d_model
        qkv = self.d_model * (self.q_dim + 2 * self.kv_dim)
        return qkv + o

    def ffn_params(self) -> int:
        mult = 3 if self.glu else 2
        per = mult * self.d_model * self.d_ff
        if self.moe:
            return per * self.moe.num_experts + self.d_model * self.moe.num_experts
        return per

    def layer_params(self) -> int:
        if self.family == "ssm" and self.ssm is not None:
            d_in = self.d_model * self.ssm.expand
            nheads = d_in // self.ssm.head_dim
            in_proj = self.d_model * (2 * d_in + 2 * self.ssm.d_state + nheads)
            out = d_in * self.d_model
            return in_proj + out + 2 * self.d_model
        n_attn = sum(1 for b in self.block_pattern if b == "attn")
        n_rec = len(self.block_pattern) - n_attn
        frac_attn = n_attn / len(self.block_pattern)
        attn = self.attn_params() * frac_attn
        rec = 0.0
        if n_rec:
            # rg-lru block: in/out proj + gates ~ 3*d*d_rnn with d_rnn ~ d
            rec = (1 - frac_attn) * 4 * self.d_model * self.d_model
        return int(attn + rec + self.ffn_params() + 2 * self.d_model)

    def param_count(self) -> int:
        emb = self.vocab * self.d_model
        head = 0 if self.tie_embeddings else self.vocab * self.d_model
        enc = self.n_enc_layers * (self.attn_params() + self.ffn_params())
        return emb + head + self.n_layers * self.layer_params() + enc + self.d_model

    def active_param_count(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
        if not self.moe:
            return self.param_count()
        dense = self.param_count() - self.n_layers * self.ffn_params()
        per_expert = (3 if self.glu else 2) * self.d_model * self.d_ff
        active_ffn = self.n_layers * per_expert * self.moe.top_k
        return dense + active_ffn

    def runnable(self, shape: ShapeSpec) -> tuple[bool, str]:
        """Cell applicability (skips recorded in EXPERIMENTS.md)."""
        if shape.name == "long_500k" and not self.subquadratic:
            return False, ("full quadratic attention: 512k-token decode has no "
                           "sub-quadratic path on this arch (see DESIGN.md §4)")
        return True, ""

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab=512,
            head_dim=16 if self.head_dim else 0,
            moe=MoEConfig(4, min(self.moe.top_k, 2)) if self.moe else None,
            ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=32,
                          conv_width=4) if self.ssm else None,
            n_enc_layers=2 if self.enc_dec else 0,
            enc_frames=16 if self.enc_dec else self.enc_frames,
            n_patches=8 if self.n_patches else 0,
            window=min(self.window, 64) if self.window else 0,
            local_window=64,
            dtype="float32",
        )
