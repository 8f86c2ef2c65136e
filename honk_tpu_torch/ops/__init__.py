"""Hand-written Hopper kernels, each with its plain PyTorch version beside it.

``mfcc_kernel`` (csrc/mfcc.cu) and ``res_kernel`` (csrc/res_stack.cu); the
sources are built with nvcc at first use by ``_build``. Importing these
modules builds nothing.
"""

from .mfcc_kernel import mfcc, mfcc_plain
from .res_kernel import pack_res_params, res_stack, res_stack_plain

__all__ = ["mfcc", "mfcc_plain", "pack_res_params", "res_stack", "res_stack_plain"]
