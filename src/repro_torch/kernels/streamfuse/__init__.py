from .chain import (GRAD_LIBRARY, LIBRARY, fused_matmul_chain,
                    fused_matmul_grad, matmul_chain_plain, matmul_grad_plain)
from .ops import register
from .ref import matmul_chain_ref, matmul_grad_ref

__all__ = ["GRAD_LIBRARY", "LIBRARY", "fused_matmul_chain",
           "fused_matmul_grad", "matmul_chain_plain", "matmul_chain_ref",
           "matmul_grad_plain", "matmul_grad_ref", "register"]
