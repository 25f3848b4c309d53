"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version.  Wrappers run the kernel on CUDA tensors and the plain
version on CPU tensors; ``build.LAUNCHES`` counts kernel launches."""
from .build import LAUNCHES, reset_launches
from .encode import (encode_matmul, encode_matmul_plain, encode_matmul_rng,
                     encode_matmul_rng_plain, philox_normal_plain,
                     quantize_tile_plain, rram_encode_matmul)
from .rram_mvm import (ec_group_matmul, ec_group_matmul_plain,
                       ec_group_rmatmul, ec_group_rmatmul_plain, ec_matmul,
                       ec_matmul_plain, ec_rmatmul, ec_rmatmul_plain,
                       matmul_layout, rmatmul_layout)
from .solver_update import (cg_update, cg_update_plain, richardson_update,
                            richardson_update_plain)
from .tridiag import (stencil_denoise, stencil_denoise_plain, thomas_solve,
                      thomas_solve_plain)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "ec_matmul",
    "ec_matmul_plain",
    "ec_rmatmul",
    "ec_rmatmul_plain",
    "ec_group_matmul",
    "ec_group_matmul_plain",
    "ec_group_rmatmul",
    "ec_group_rmatmul_plain",
    "matmul_layout",
    "rmatmul_layout",
    "encode_matmul",
    "encode_matmul_plain",
    "encode_matmul_rng",
    "encode_matmul_rng_plain",
    "rram_encode_matmul",
    "quantize_tile_plain",
    "philox_normal_plain",
    "stencil_denoise",
    "stencil_denoise_plain",
    "thomas_solve",
    "thomas_solve_plain",
    "cg_update",
    "cg_update_plain",
    "richardson_update",
    "richardson_update_plain",
]
