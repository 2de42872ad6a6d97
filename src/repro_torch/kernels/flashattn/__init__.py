from .flashattn import LIBRARY, flash_attention, flash_attention_plain
from .ops import flash_attn
from .patterns import register
from .ref import attention_ref

__all__ = ["LIBRARY", "attention_ref", "flash_attention",
           "flash_attention_plain", "flash_attn", "register"]
