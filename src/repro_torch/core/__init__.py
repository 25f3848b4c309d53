"""MELISO+ core, PyTorch port: device models, virtualization, two-tier error
correction and the local crossbar stages (see :mod:`repro.core`)."""

from .crossbar import (CrossbarConfig, assemble_blocks, corrected_mvm,
                       encode_tiled, group_program_blocks, grouped_block_mvm,
                       grouped_block_rmvm, input_write_cost,
                       matrix_write_cost, program_blocks,
                       programmed_block_mvm, programmed_block_rmvm,
                       tile_write_cost, write_cost)
from .devices import (DEVICES, DeviceModel, effective_sigma,
                      effective_sigma_py, encode, get_device, quantize)
from .error_correction import (build_l_matrix, corrected_matmul,
                               corrected_matvecmul, denoise_least_square,
                               first_order_correct, tridiag_coeffs)
from .metrics import rel_l2, rel_linf, relative_error
from .prng import block_key, fold_in, generator
from .virtualization import (MCAGeometry, block_partition, blocks_view,
                             reassemble, reassignment_count, zero_padding)
from .write_verify import WriteStats

__all__ = [n for n in dir() if not n.startswith("_")]
