"""meliso-mvm -- the paper's own workload: distributed two-tier-EC corrected
MVM at 65,536 x 65,536 (exceeding the paper's 65,025 strong-scaling ceiling),
virtualized onto 512x512-cell MCA tiles across the mesh."""
from .base import ArchConfig, ModelConfig

ARCH = ArchConfig(
    name="meliso-mvm",
    model=ModelConfig(
        family="meliso", d_model=65536,   # problem dimension n
        param_dtype="float32", compute_dtype="float32",
    ),
    shapes=("mvm_65k",),
    source="this paper (MELISO+)",
)
