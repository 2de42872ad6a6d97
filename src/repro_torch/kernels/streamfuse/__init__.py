from .chain import (GRAD_LIBRARY, LIBRARY, SOFTMAX_LIBRARY, fused_matmul_chain,
                    fused_matmul_grad, fused_softmax_matmul,
                    matmul_chain_plain, matmul_grad_plain,
                    softmax_matmul_plain)
from .ops import pad_conv_relu, register
from .ref import (matmul_chain_ref, matmul_grad_ref, pad_conv_relu_ref,
                  softmax_matmul_ref)
from .streamfuse import LIBRARY as CONV_LIBRARY
from .streamfuse import fused_pad_conv_relu, pad_conv_relu_plain

__all__ = ["CONV_LIBRARY", "GRAD_LIBRARY", "LIBRARY", "SOFTMAX_LIBRARY",
           "fused_matmul_chain", "fused_matmul_grad", "fused_pad_conv_relu",
           "fused_softmax_matmul", "matmul_chain_plain", "matmul_chain_ref",
           "matmul_grad_plain", "matmul_grad_ref", "pad_conv_relu",
           "pad_conv_relu_plain", "pad_conv_relu_ref", "register", "softmax_matmul_plain",
           "softmax_matmul_ref"]
