"""The port's CUDA kernels on the card, each held to its plain version, and
the ``cuda`` engine/solver path on the card held to the same path on the
CPU (plain versions) with the same injected noise.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
This file imports neither ``jax`` nor ``repro``, so it runs on a machine
with the port alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels, solvers
from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
from repro_torch.engine import AnalogEngine, AnalogMatrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def randn(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(dev)


def rel(got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


@pytest.mark.parametrize("batch", [1, 3, 8, 11])
def test_kernels_match_plain_versions(cuda_device, batch):
    """Non-multiple shapes; batch 11 takes two ec_matmul launches."""
    dev = cuda_device
    m, k = 1000, 1500
    at, da = randn((m, k), 0, dev), randn((m, k), 1, dev)
    x, xt = randn((k, batch), 2, dev), randn((k, batch), 3, dev)
    kernels.reset_launches()
    got = kernels.ec_matmul(at, da, x, xt)
    assert kernels.LAUNCHES["ec_matmul"] == -(-batch // 8)
    assert rel(got, kernels.ec_matmul_plain(at, da, x, xt)) <= 1e-5
    p = randn((m, batch), 4, dev)
    assert rel(kernels.stencil_denoise(p, 1e-2),
               kernels.stencil_denoise_plain(p, 1e-2)) <= 1e-6
    v = [randn((m, batch), s, dev) for s in range(5, 9)]
    alpha = randn((batch,), 9, dev)
    for g, w in zip(kernels.cg_update(*v, alpha),
                    kernels.cg_update_plain(*v, alpha)):
        assert rel(g, w) <= 1e-6
    om = torch.tensor(0.37, device=dev)
    for g, w in zip(kernels.richardson_update(*v[:3], om),
                    kernels.richardson_update_plain(*v[:3], om)):
        assert rel(g, w) <= 1e-6
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[n] == 1 for n in
               ("stencil_denoise", "cg_update", "richardson_update"))


def test_engine_on_card_matches_cpu_path(cuda_device):
    """One image, one injected DAC draw: the ``cuda`` backend on the card
    (kernels) equals the same backend on the CPU (plain versions)."""
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 64, 64))
    a, x = randn((300, 260), 10, "cpu"), randn((260, 4), 11, "cpu")
    cpu = AnalogEngine(cfg, backend="cuda", device="cpu")
    A = cpu.program(a, 3)
    gpu = AnalogEngine(cfg, backend="cuda", device=cuda_device)
    G = AnalogMatrix(engine=gpu, shape=A.shape, base_key=A.base_key,
                     write_stats=A.write_stats,
                     at_pad=A.at_pad.to(cuda_device),
                     da_pad=A.da_pad.to(cuda_device))
    eta = randn((A.at_pad.shape[1], 4), 12, "cpu")
    kernels.reset_launches()
    got = gpu.mvm(G, x.to(cuda_device), eta=eta.to(cuda_device))
    assert kernels.LAUNCHES["ec_matmul"] == 1
    assert kernels.LAUNCHES["stencil_denoise"] == 1
    assert rel(got.cpu(), cpu.mvm(A, x, eta=eta)) <= 1e-5


def test_deviceless_operands_solve_on_card(cuda_device):
    """A numpy matrix and right-hand side with no ``device=`` solve on the
    card."""
    n = 64
    a = np.random.default_rng(15).standard_normal((n, n)).astype(np.float32)
    a = (a + a.T) / n + 2.0 * np.eye(n, dtype=np.float32)
    b = np.ones(n, np.float32)
    assert solvers.as_operator(a).device.type == "cuda"
    res = solvers.cg(a, b, tol=1e-6, maxiter=50)
    assert res.x.device.type == "cuda" and res.converged


def test_solves_on_card(cuda_device):
    n = 512
    r = randn((n, n), 13, "cpu") / n
    a = r + r.T + 2.0 * torch.eye(n)
    x_true = randn((n,), 14, "cpu")
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 128, 128))
    A = AnalogEngine(cfg, backend="cuda", device=cuda_device).program(a, 0)
    b = (a @ x_true).to(cuda_device)
    kernels.reset_launches()
    for solve, update in ((solvers.cg, "cg_update"),
                          (solvers.richardson, "richardson_update")):
        res = solve(A, b, tol=1e-3, maxiter=50, backend="cuda")
        assert res.converged
        assert rel(res.x.cpu(), x_true) <= 1e-3
        assert kernels.LAUNCHES[update] == res.iterations
