from .chain import LIBRARY, fused_matmul_chain, matmul_chain_plain
from .ops import register
from .ref import matmul_chain_ref

__all__ = ["LIBRARY", "fused_matmul_chain", "matmul_chain_plain",
           "matmul_chain_ref", "register"]
