"""Hand-written Hopper kernels, each with its plain PyTorch version beside it.

``mfcc_kernel`` (csrc/mfcc.cu), ``res_kernel`` (csrc/res_stack.cu),
``assemble_kernel`` (csrc/assemble.cu) and ``wgrad_kernel``
(csrc/conv_wgrad.cu); the sources are built with nvcc at first use by
``_build``. Importing these modules builds nothing.
"""

from .assemble_kernel import assemble, assemble_plain, pack_noise_subrows, pack_pool_subrows
from .mfcc_kernel import mfcc, mfcc_plain
from .res_kernel import (pack_res_params, res_forward, res_forward_fused, res_forward_plain, res_stack,
                         res_stack_plain)
from .wgrad_kernel import conv_wgrad, conv_wgrad_plain

__all__ = [
    "assemble", "assemble_plain", "conv_wgrad", "conv_wgrad_plain", "mfcc", "mfcc_plain", "pack_noise_subrows",
    "pack_pool_subrows", "pack_res_params", "res_forward", "res_forward_fused", "res_forward_plain", "res_stack",
    "res_stack_plain",
]
