"""MELISO+ core, PyTorch port: device models, virtualization, two-tier error
correction, closed-loop write-and-verify, benchmark matrices (the implicit
banded producer included), the crossbar stages, local and streamed, and the
distributed placement over a mesh of ranks (see :mod:`repro.core`)."""

from .crossbar import (CrossbarConfig, assemble_blocks, corrected_mvm,
                       encode_tiled, group_program_blocks, grouped_block_mvm,
                       grouped_block_rmvm, grouped_streamed_block_mvm,
                       grouped_streamed_block_rmvm,
                       grouped_streamed_program_blocks, input_write_cost,
                       matrix_write_cost, produce_blocks, program_blocks,
                       programmed_block_mvm, programmed_block_rmvm,
                       streamed_block_mvm, streamed_block_rmvm,
                       streamed_corrected_mvm, streamed_program_blocks,
                       tile_write_cost, write_cost)
from .distributed import (distributed_corrected_mvm,
                          make_distributed_group_mvm,
                          make_distributed_group_program,
                          make_distributed_group_rmvm,
                          make_distributed_program,
                          make_distributed_programmed_mvm,
                          make_distributed_rmvm,
                          make_distributed_streamed_mvm,
                          make_distributed_streamed_program,
                          make_distributed_streamed_rmvm, mesh_grid_shape,
                          shard_matrix)
from .devices import (DEVICES, DeviceModel, drift_factor, drift_factor_py,
                      effective_sigma, effective_sigma_py, encode, get_device,
                      quantize)
from .error_correction import (build_l_matrix, corrected_matmul,
                               corrected_matvecmul, denoise_least_square,
                               first_order_correct, tridiag_coeffs)
from .matrices import (PAPER_MATRICES, ImplicitBandedMatrix,
                       make_iperturb, make_spd_with_condition, paper_matrix)
from .metrics import rel_l2, rel_linf, relative_error
from .prng import block_key, fold_in, generator
from .virtualization import (MCAGeometry, block_partition, blocks_view,
                             generate_mat_chunks, generate_vec_chunks,
                             reassemble, reassignment_count, zero_padding)
from .write_verify import (WriteStats, adjustable_mat_write_and_verify,
                           adjustable_vec_write_and_verify,
                           adjustable_write_and_verify,
                           refresh_write_and_verify)

__all__ = [n for n in dir() if not n.startswith("_")]
