"""Program-once / execute-many analog MVM engine (port of :mod:`repro.engine`,
local placement).

``engine.program(a, key)`` pays the write cost once and returns an
:class:`AnalogMatrix` handle holding the padded conductance image
``A_tilde`` and the tier-1 correction operand ``dA = A - A_tilde``, each one
dense ``(Mp, Np)`` float32 tensor (the block layout is a view, see
:attr:`AnalogMatrix.at_blocks`); ``engine.mvm(A, x)`` or ``A @ x`` then runs
tier-1 error correction and tier-2 denoising with only the input vector
passing through the DAC, for ``x`` of shape ``(n,)`` or ``(n, batch)``.

Backends:

  * ``"reference"`` -- :func:`repro_torch.core.crossbar.programmed_block_mvm`,
    plain PyTorch, one DAC draw per capacity block;
  * ``"cuda"`` -- the mirror of the JAX engine's ``_pallas_corrected``: one
    DAC pass over the whole padded input, tier-1 through the
    :func:`~repro_torch.kernels.ec_matmul` kernel, tier-2 through the
    :func:`~repro_torch.kernels.stencil_denoise` kernel (the default
    ``denoise_method="neumann"``).  On CPU tensors the kernels' plain
    versions run, which is how the tests drive it.

Only ``execution="local"`` exists so far; ``"streamed"`` and
``"distributed"`` raise ``NotImplementedError`` naming their ROADMAP item.
Keys are integers (:mod:`repro_torch.core.prng`); call ``c`` of a handle
draws its DAC noise from ``key`` for ``c == 0`` and ``fold_in(key, c)``
after, as the JAX engine does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels
from .core import crossbar
from .core.crossbar import CrossbarConfig
from .core.error_correction import denoise_least_square
from .core.prng import fold_in, generator
from .core.virtualization import blocks_view
from .core.write_verify import WriteStats

__all__ = ["AnalogEngine", "AnalogMatrix", "EXECUTION_MODES", "BACKENDS"]

EXECUTION_MODES = ("local", "streamed", "distributed")
BACKENDS = ("reference", "cuda")

_NOT_PORTED = {
    "streamed": "ROADMAP Queue A7 (streamed execution)",
    "distributed": "ROADMAP Queue A11 (distributed placement)",
}


@dataclasses.dataclass(eq=False)
class AnalogMatrix:
    """Handle to a matrix programmed onto the (simulated) analog hardware.

    Holds the padded image ``at_pad`` (``A_tilde``) and correction operand
    ``da_pad`` (``dA``), each (Mp, Np), the one-time programming
    :class:`WriteStats`, and the base key whose folds drive the input DAC
    noise of successive executions.
    """

    engine: "AnalogEngine"
    shape: Tuple[int, int]
    base_key: int
    write_stats: WriteStats
    at_pad: torch.Tensor
    da_pad: torch.Tensor
    calls: int = 0

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def at_blocks(self) -> torch.Tensor:
        """(mb, nb, cap_m, cap_n) block view of ``A_tilde`` (no copy)."""
        return blocks_view(self.at_pad, self.engine.cfg.geom)

    @property
    def da_blocks(self) -> torch.Tensor:
        """(mb, nb, cap_m, cap_n) block view of ``dA`` (no copy)."""
        return blocks_view(self.da_pad, self.engine.cfg.geom)

    @property
    def a_tilde(self) -> torch.Tensor:
        """The programmed conductance image, unpadded (m, n) view."""
        return crossbar.assemble_blocks(self.at_pad, self.m, self.n)

    @property
    def da(self) -> torch.Tensor:
        """The tier-1 correction operand A - A_tilde, unpadded (m, n) view."""
        return crossbar.assemble_blocks(self.da_pad, self.m, self.n)

    def dense(self) -> torch.Tensor:
        """The exact source matrix A = A_tilde + dA, unpadded (m, n)."""
        return self.a_tilde + self.da

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.engine.mvm(self, x)

    def input_write_stats(self, batch: int = 1) -> WriteStats:
        """Per-execution write cost (x DAC pass + EC X^T replica)."""
        return self.engine.input_write_stats(self, batch)

    @property
    def image_nbytes(self) -> int:
        """Resident bytes of the programmed operands (the two padded images;
        there are no derived caches)."""
        return self.at_pad.nbytes + self.da_pad.nbytes

    def release(self) -> int:
        """Drop derived execution caches, returning the bytes freed.  The port
        keeps none (the padded images ARE the stored layout), so this frees
        0 bytes; the image itself goes when the handle goes."""
        return 0


def _cuda_corrected(at: torch.Tensor, da: torch.Tensor, xb: torch.Tensor,
                    key: int, cfg: CrossbarConfig, m: int, *,
                    eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``cuda`` backend's execute, mirroring the JAX ``_pallas_corrected``.

    One DAC pass over the whole padded input (one scale, one draw from
    ``fold_in(key, 1)``; ``eta`` of shape ``(Np, batch)`` replaces it),
    tier-1 ``A_tilde x + dA x_tilde`` through the ``ec_matmul`` kernel and
    tier-2 through the ``stencil_denoise`` kernel.
    """
    x_pad = F.pad(xb, (0, 0, 0, at.shape[1] - xb.shape[0])).contiguous()
    if not cfg.encode_inputs:
        x_t = x_pad
    elif eta is None:
        x_t = crossbar._encode_vec(
            x_pad, cfg, gen=generator(fold_in(key, 1), x_pad.device))
    else:
        x_t = crossbar._encode_vec(x_pad, cfg, eta=eta)
    if not cfg.ec:
        return (at @ x_t)[:m]
    p = kernels.ec_matmul(at, da, x_pad, x_t)[:m]
    if cfg.denoise_method == "neumann":
        return kernels.stencil_denoise(p, cfg.lam, cfg.h)
    if cfg.denoise_method == "thomas":
        raise NotImplementedError(
            "denoise_method='thomas' on backend='cuda' needs the thomas_solve "
            "kernel, ROADMAP Queue B1 (not ported yet)")
    return denoise_least_square(p, lam=cfg.lam, h=cfg.h,
                                method=cfg.denoise_method)


class AnalogEngine:
    """Program-once / execute-many corrected-MVM engine.

    Parameters
    ----------
    cfg:
        The :class:`CrossbarConfig` of one multi-MCA system.
    execution:
        ``"local"`` only, for now.
    backend:
        ``"reference"`` (plain PyTorch block pipeline) | ``"cuda"`` (the
        hand-written kernels; their plain versions on a CPU ``device``).
    device:
        Where images and executions live; ``"cuda"`` unless the caller asks
        for the CPU.
    """

    def __init__(self, cfg: CrossbarConfig, *, execution: str = "local",
                 backend: str = "reference", device="cuda"):
        if execution not in EXECUTION_MODES:
            raise ValueError(f"unknown execution mode {execution!r}; expected "
                             f"one of {EXECUTION_MODES}")
        if execution != "local":
            raise NotImplementedError(
                f"execution={execution!r} is not ported yet: "
                f"{_NOT_PORTED[execution]}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        self.cfg = cfg
        self.execution = execution
        self.backend = backend
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # Pin "cuda" to an index so it compares equal to tensor devices.
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    # ------------------------------------------------------------- programming
    def _as_tensor(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return torch.as_tensor(a).to(device=self.device, dtype=torch.float32)

    def program(self, a, key: int, *,
                eta: Optional[torch.Tensor] = None) -> AnalogMatrix:
        """Write the dense (m, n) ``a`` onto the analog system once; returns the
        reusable handle.  ``eta`` ((mb, nb, cap_m, cap_n)) replaces the
        programming noise draws (see :func:`crossbar.program_blocks`)."""
        a = self._as_tensor(a)
        if a.ndim != 2:
            raise ValueError(f"program expects a matrix, got shape "
                             f"{tuple(a.shape)}")
        m, n = a.shape
        at, da = crossbar.program_blocks(a, key, self.cfg, eta=eta)
        return AnalogMatrix(engine=self, shape=(m, n), base_key=int(key),
                            write_stats=crossbar.matrix_write_cost(m, n,
                                                                   self.cfg),
                            at_pad=at, da_pad=da)

    def encode_dense(self, a, key: int) -> torch.Tensor:
        """The programmed image of ``a`` as a dense unpadded tensor."""
        a = self._as_tensor(a)
        at, _ = crossbar.program_blocks(a, key, self.cfg)
        return crossbar.assemble_blocks(at, *a.shape)

    # --------------------------------------------------------------- execution
    def mvm(self, A: AnalogMatrix, x, *, key: Optional[int] = None,
            eta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Corrected MVM against the programmed image: zero re-encode work.

        ``x``: (n,) or (n, batch).  ``key`` overrides the call's DAC key;
        by default call ``c`` uses the handle's key schedule.  ``eta``
        replaces the DAC draws: ``(Np, batch)`` for ``backend="cuda"``,
        ``(mb, nb, cap_n, batch)`` for ``"reference"``.
        """
        y, _ = self._execute(A, x, key, eta)
        return y

    def mvm_with_stats(self, A: AnalogMatrix, x, *, key: Optional[int] = None,
                       eta: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, WriteStats]:
        """Like :meth:`mvm` but also returns this call's input-write cost."""
        y, batch = self._execute(A, x, key, eta)
        return y, self.input_write_stats(A, batch)

    def input_write_stats(self, A: AnalogMatrix, batch: int = 1) -> WriteStats:
        """Per-execution input-write cost (x DAC pass + EC X^T replica)."""
        return crossbar.input_write_cost(A.m, A.n, self.cfg, batch=batch)

    def _execute(self, A: AnalogMatrix, x, key, eta):
        if A.engine is not self and A.engine.cfg != self.cfg:
            raise ValueError("AnalogMatrix was programmed by an incompatible "
                             "engine configuration")
        if A.at_pad.device != self.device:
            raise ValueError(f"AnalogMatrix lives on {A.at_pad.device} but this "
                             f"engine executes on {self.device}")
        x = self._as_tensor(x)
        squeeze = x.ndim == 1
        xb = x[:, None] if squeeze else x
        if xb.shape[0] != A.n:
            raise ValueError(f"A @ x: input has {xb.shape[0]} rows but the "
                             f"programmed matrix is {A.m} x {A.n}")
        if key is None:
            key = A.base_key if A.calls == 0 else fold_in(A.base_key, A.calls)
        A.calls += 1
        if self.backend == "cuda":
            p = _cuda_corrected(A.at_pad, A.da_pad, xb, key, self.cfg, A.m,
                                eta=eta)
        else:
            p = crossbar.programmed_block_mvm(A.at_pad, A.da_pad, xb, key,
                                              self.cfg,
                                              m=A.m, n=A.n, eta=eta)
        return (p[:, 0] if squeeze else p), xb.shape[1]
