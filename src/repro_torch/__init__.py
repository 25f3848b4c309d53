"""repro_torch: the PyTorch/CUDA port of :mod:`repro` (MELISO+ analog
in-memory computing with integrated error correction) for NVIDIA Hopper.

Mirrors the JAX package's layout (``core``, ``kernels``, ``engine``,
``solvers``); every kernel that the JAX package wrote in Pallas is a
hand-written CUDA kernel here, beside its plain PyTorch version.  The
engine programs a dense matrix (``execution="local"``) or a
``block_fn(i, j)`` producer such as :class:`ImplicitBandedMatrix`'s
``block`` (``execution="streamed"``, the paper's 65,025^2 scale), either of
them over a mesh of ranks (``execution="distributed"``,
``launch.make_mesh``).  Imports ``torch`` only -- never ``jax`` and nothing
of ``repro``.
"""
__version__ = "0.1.0"

from repro_torch.core.matrices import ImplicitBandedMatrix  # noqa: E402,F401
from repro_torch.engine import AnalogEngine, AnalogMatrix  # noqa: E402,F401
