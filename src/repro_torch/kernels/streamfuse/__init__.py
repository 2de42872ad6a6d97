from .chain import (GRAD_LIBRARY, LIBRARY, fused_matmul_chain,
                    fused_matmul_grad, matmul_chain_plain, matmul_grad_plain)
from .ops import register
from .ref import matmul_chain_ref, matmul_grad_ref, pad_conv_relu_ref
from .streamfuse import LIBRARY as CONV_LIBRARY
from .streamfuse import fused_pad_conv_relu, pad_conv_relu_plain

__all__ = ["CONV_LIBRARY", "GRAD_LIBRARY", "LIBRARY", "fused_matmul_chain",
           "fused_matmul_grad", "fused_pad_conv_relu", "matmul_chain_plain",
           "matmul_chain_ref", "matmul_grad_plain", "matmul_grad_ref",
           "pad_conv_relu_plain", "pad_conv_relu_ref", "register"]
