"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version.  Wrappers run the kernel on CUDA tensors and the plain
version on CPU tensors; ``build.LAUNCHES`` counts kernel launches."""
from .build import LAUNCHES, reset_launches
from .rram_mvm import ec_matmul, ec_matmul_plain
from .solver_update import (cg_update, cg_update_plain, richardson_update,
                            richardson_update_plain)
from .tridiag import stencil_denoise, stencil_denoise_plain

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "ec_matmul",
    "ec_matmul_plain",
    "stencil_denoise",
    "stencil_denoise_plain",
    "cg_update",
    "cg_update_plain",
    "richardson_update",
    "richardson_update_plain",
]
