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


@pytest.mark.parametrize("batch", [1, 3, 8, 11])
def test_transposed_and_thomas_kernels_match_plain_versions(cuda_device,
                                                            batch):
    """``ec_rmatmul`` (one slab and several; batch 11 takes two launches)
    and ``thomas_solve`` at lam = 1e-2 (where it is not the identity) and at
    the engine's 1e-12, on ragged shapes."""
    dev = cuda_device
    for m, k in ((1000, 1500), (4100, 300)):
        at, da = randn((m, k), 20, dev), randn((m, k), 21, dev)
        y, yt = randn((m, batch), 22, dev), randn((m, batch), 23, dev)
        kernels.reset_launches()
        got = kernels.ec_rmatmul(at, da, y, yt)
        assert kernels.LAUNCHES["ec_rmatmul"] == -(-batch // 8)
        assert got.shape == (k, batch)
        assert rel(got, kernels.ec_rmatmul_plain(at, da, y, yt)) <= 1e-5
        assert torch.equal(got, kernels.ec_rmatmul(at, da, y, yt))
    for n in (1000, 5000):
        p = randn((n, batch), 24, dev)
        for lam in (1e-2, 1e-12):
            got = kernels.thomas_solve(p, lam)
            assert rel(got, kernels.thomas_solve_plain(p, lam)) <= 1e-6
        assert rel(kernels.thomas_solve(p, 1e-2), p) > 1e-3
    torch.cuda.synchronize()


def test_rmatmul_splits_fill_the_card(cuda_device):
    """The transposed launcher cuts the rows into slabs so that a
    32,768-column image still gives each of an H100 SXM's 132 SMs several
    blocks (128 column tiles x 9 slabs), a short image takes one slab per
    64 rows at most, and one slab needs no workspace."""
    from repro_torch.kernels.rram_mvm import _rmatmul_workspace
    props = torch.cuda.get_device_properties(cuda_device)
    if props.multi_processor_count != 132:
        pytest.skip("the slab counts below are those of a 132-SM card")
    dev = torch.device("cuda", torch.cuda.current_device())
    assert _rmatmul_workspace(32768, 32768, 1, dev) == 9 * 32768
    assert _rmatmul_workspace(32768, 16384, 8, dev) == 17 * 16384 * 8
    assert _rmatmul_workspace(100, 32768, 1, dev) == 2 * 32768
    assert _rmatmul_workspace(5, 10, 1, dev) == 0


def test_thomas_kernel_wide_panel(cuda_device):
    """More columns than one block takes (32): two blocks, ragged."""
    p = randn((300, 40), 25, cuda_device)
    assert rel(kernels.thomas_solve(p, 0.5),
               kernels.thomas_solve_plain(p, 0.5)) <= 1e-5


@pytest.mark.parametrize("transpose", [False, True])
def test_ec_kernels_on_a_block_view(cuda_device, transpose):
    """One capacity block of a padded image as a view (row stride > width),
    no copy, equals the kernel on the block copied out and the plain
    version."""
    dev = cuda_device
    image, corr = randn((512, 768), 26, dev), randn((512, 768), 27, dev)
    at, da = image[256:512, 256:512], corr[256:512, 256:512]
    assert at.stride() == (768, 1)
    u = randn((256, 3), 28, dev)
    run = kernels.ec_rmatmul if transpose else kernels.ec_matmul
    plain = kernels.ec_rmatmul_plain if transpose else kernels.ec_matmul_plain
    got = run(at, da, u, 1.01 * u)
    assert rel(got, run(at.contiguous(), da.contiguous(), u, 1.01 * u)) \
        <= 1e-6
    assert rel(got, plain(at, da, u, 1.01 * u)) <= 1e-5


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


@pytest.mark.parametrize("method", ["neumann", "thomas"])
def test_transposed_engine_on_card_matches_cpu_path(cuda_device, method):
    """``A.T @ y`` on the card (``ec_rmatmul`` + tier-2 kernel) equals the
    same backend on the CPU with one injected DAC draw; the Thomas tier-2 at
    lam = 1e-2 in both directions; the reference block stage with
    ``use_kernel=True`` on the card equals it without."""
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 64, 64),
                         denoise_method=method, lam=1e-2)
    a, y = randn((300, 260), 30, "cpu"), randn((300, 4), 31, "cpu")
    cpu = AnalogEngine(cfg, backend="cuda", device="cpu")
    A = cpu.program(a, 3)
    gpu = AnalogEngine(cfg, backend="cuda", device=cuda_device)
    G = AnalogMatrix(engine=gpu, shape=A.shape, base_key=A.base_key,
                     write_stats=A.write_stats,
                     at_pad=A.at_pad.to(cuda_device),
                     da_pad=A.da_pad.to(cuda_device))
    eta = randn((A.at_pad.shape[0], 4), 32, "cpu")
    kernels.reset_launches()
    got = gpu.rmvm(G, y.to(cuda_device), eta=eta.to(cuda_device))
    tier2 = "thomas_solve" if method == "thomas" else "stencil_denoise"
    assert kernels.LAUNCHES["ec_rmatmul"] == 1
    assert kernels.LAUNCHES[tier2] == 1
    assert rel(got.cpu(), cpu.rmvm(A, y, eta=eta)) <= 1e-5
    x = randn((260, 2), 33, "cpu")
    eta = randn((A.at_pad.shape[1], 2), 34, "cpu")
    assert rel(gpu.mvm(G, x.to(cuda_device), eta=eta.to(cuda_device)).cpu(),
               cpu.mvm(A, x, eta=eta)) <= 1e-5
    from repro_torch.core import crossbar
    for stage in (crossbar.programmed_block_mvm,
                  crossbar.programmed_block_rmvm):
        u = (y if stage is crossbar.programmed_block_rmvm else x)
        u = u.to(cuda_device)
        want = stage(G.at_pad, G.da_pad, u, 5, cfg, m=300, n=260)
        kernels.reset_launches()
        got = stage(G.at_pad, G.da_pad, u, 5, cfg, m=300, n=260,
                    use_kernel=True)
        assert sum(kernels.LAUNCHES.values()) >= 4    # a launch per block
        assert rel(got, want) <= 1e-5


def test_lstsq_and_pdhg_on_card(cuda_device):
    """LSQR, LSMR and PDHG on programmed images on the card (epiram, EC on)
    converge and go through ``ec_rmatmul`` once per transposed MVM."""
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 128, 128))
    eng = AnalogEngine(cfg, backend="cuda", device=cuda_device)
    a = randn((600, 300), 35, "cpu") / 600 ** 0.5
    x_true = randn((300,), 36, "cpu")
    A = eng.program(a, 0)
    b = (a @ x_true).to(cuda_device)
    for solve in (solvers.lsqr, solvers.lsmr):
        kernels.reset_launches()
        res = solve(A, b, tol=1e-3, maxiter=100)
        assert res.converged and res.x.device.type == "cuda"
        assert rel(res.x.cpu(), x_true) <= 3e-2
        assert kernels.LAUNCHES["ec_rmatmul"] == res.ledger.mvms_t
    a, b, c, x_star, _ = solvers.random_feasible_lp(5, 200, 400,
                                                    device=cuda_device)
    kernels.reset_launches()
    res = solvers.pdhg(eng.program(a, 1), b, c, tol=1e-3, maxiter=5000)
    assert res.converged
    assert kernels.LAUNCHES["ec_rmatmul"] == res.ledger.mvms_t + 16
    obj = float(c @ x_star)
    assert abs(float(c @ res.x) - obj) / (1 + abs(obj)) <= 1e-2


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
