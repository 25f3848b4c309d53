"""The port's CUDA kernels on the card, each held to its plain version, and
the ``cuda`` engine/solver path on the card (solo and grouped) held to the
same path on the CPU (plain versions) with the same injected noise.

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
    """``ec_rmatmul`` (one block and many; batch 11 takes two launches)
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


def _block_ranges(lay):
    """Each block's units [begin, end) under a layout."""
    return [(b * lay.units // lay.blocks, (b + 1) * lay.units // lay.blocks)
            for b in range(lay.blocks)]


def test_rmatmul_layout_is_one_wave_and_covers_the_partials(cuda_device):
    """The transposed launcher runs at most one wave of the resident slots
    it reports (one block a unit when there are fewer units), cuts the units
    in equal shares, takes the staged kernel on 16-byte aligned images and
    register loads otherwise, and the workspace it asks for holds every
    block's partial panels: a block's units straddle at most
    ``partials_per_block`` column tiles."""
    from repro_torch.kernels.rram_mvm import rmatmul_layout
    dev = cuda_device
    big = torch.empty(32768, 32768, device=dev)
    stack = torch.empty(8, 16384, 4096, device=dev)
    cases = [(big, big, 1, 1, True), (big, big, 8, 1, True),
             (big[:, :16384], big[:, :16384], 1, 1, True),
             (big[:16384], big[:16384], 1, 1, True),
             (stack[:, :14336], stack[:, :14336], 1, 8, True),
             (stack[:, :14336], stack[:, :14336], 8, 8, True),
             (big[:5, :10], big[:5, :10], 3, 1, True),
             (big[:100, 1:1001], big[:100, 1:1001], 1, 1, False)]
    for at, da, batch, g, staged in cases:
        lay = rmatmul_layout(at, da, batch)
        m, k = at.shape[-2:]
        rows = lay.rows_per_unit
        units = g * -(-k // lay.cols_per_unit) * -(-m // rows)
        assert lay.staged == staged
        assert lay.units == units
        assert lay.blocks == min(lay.blocks_per_sm * lay.sms, units)
        assert lay.sms == torch.cuda.get_device_properties(dev) \
            .multi_processor_count
        ranges = _block_ranges(lay)
        sizes = {hi - lo for lo, hi in ranges}
        assert max(sizes) - min(sizes) <= 1
        chunks = -(-m // rows)
        tiles = max((hi - 1) // chunks - lo // chunks + 1 for lo, hi in ranges)
        assert tiles <= lay.partials_per_block
        assert lay.workspace_floats >= lay.blocks * \
            lay.partials_per_block * lay.cols_per_unit * batch
    # The main path's images fill whole waves: one block an SM for the
    # staged kernel, and no more blocks than slots.
    lay = rmatmul_layout(big, big, 1)
    assert lay.blocks == lay.blocks_per_sm * lay.sms
    del big, stack


def _check_rmatmul(at, da, batch, seed, staged):
    """ec_rmatmul (or the grouped kernel on a (g, M, K) stack) on these
    views: the variant taken, against the plain version, run to run, and a
    group of one against the solo call; returns the output."""
    from repro_torch.kernels.rram_mvm import rmatmul_layout
    dev = at.device
    g = at.shape[0] if at.ndim == 3 else 1
    m = at.shape[-2]
    y, yt = randn((m, g * batch), seed, dev), randn((m, g * batch), seed + 1,
                                                    dev)
    assert rmatmul_layout(at, da, min(batch, 8)).staged == staged
    if at.ndim == 2:
        run, plain = kernels.ec_rmatmul, kernels.ec_rmatmul_plain
    else:
        run, plain = kernels.ec_group_rmatmul, kernels.ec_group_rmatmul_plain
    kernels.reset_launches()
    got = run(at, da, y, yt)
    assert sum(kernels.LAUNCHES.values()) == -(-batch // 8)
    assert got.shape == (at.shape[-1], g * batch)
    assert rel(got, plain(at, da, y, yt)) <= 1e-5
    assert torch.equal(got, run(at, da, y, yt))
    one = (at[:1], da[:1]) if at.ndim == 3 else (at[None], da[None])
    v, vt = y[:, :batch].contiguous(), yt[:, :batch].contiguous()
    solo = kernels.ec_rmatmul(one[0][0], one[1][0], v, vt)
    assert torch.equal(kernels.ec_group_rmatmul(*one, v, vt), solo)
    if at.ndim == 3:
        assert rel(got[:, :batch], solo) <= 1e-6
    return got


@pytest.mark.parametrize("batch", [1, 3, 8, 11])
def test_rmatmul_ragged_edges_both_variants(cuda_device, batch):
    """Ragged K (1,499) and M (4,097): through the staged kernel on a view
    of a padded image (row stride 1,504, 16-byte aligned; the tensor map's
    zero fill covers the edges) and through the register kernel on the
    contiguous image (row stride 1,499) and on a view whose base is one
    float off 16 bytes."""
    dev = cuda_device
    m, k = 4097, 1499
    pad = randn((m, 1504), 70, dev), randn((m, 1504), 71, dev)
    _check_rmatmul(pad[0][:, :k], pad[1][:, :k], batch, 72, staged=True)
    tight = pad[0][:, :k].contiguous(), pad[1][:, :k].contiguous()
    _check_rmatmul(*tight, batch, 74, staged=False)
    _check_rmatmul(pad[0][:, 1:1 + k], pad[1][:, 1:1 + k], batch, 76,
                   staged=False)
    torch.cuda.synchronize()


@pytest.mark.parametrize("batch", [1, 3, 8, 11])
@pytest.mark.parametrize("g", [3, 5, 8])
def test_group_rmatmul_units_straddle_members(cuda_device, g, batch):
    """Groups of 3, 5 and 8 ragged members (4,097 x 1,499 live views of
    padded stacks, and the same stacks with an unaligned base), whose
    blocks' unit ranges cross from one member into the next wherever the
    block count is not a multiple of g (where it is, as for 3 members on
    132 SMs, members start on block boundaries): against the plain version,
    run to run, each member against its solo call to 1e-6, and a group of
    one equal to the solo call bit for bit."""
    from repro_torch.kernels.rram_mvm import rmatmul_layout
    dev = cuda_device
    m, k = 4097, 1499
    stack = randn((g, m + 3, 1504), 80, dev), randn((g, m + 3, 1504), 81, dev)
    views = [(stack[0][:, :m, :k], stack[1][:, :m, :k], True),
             (stack[0][:, :m, 3:3 + k], stack[1][:, :m, 3:3 + k], False)]
    for at, da, staged in views:
        lay = rmatmul_layout(at, da, min(batch, 8))
        per_member = lay.units // g
        straddle = any(lo // per_member != (hi - 1) // per_member
                       for lo, hi in _block_ranges(lay))
        assert straddle == (lay.blocks % g != 0)
        got = _check_rmatmul(at, da, batch, 82, staged)
        y = randn((m, g * batch), 82, dev)
        yt = randn((m, g * batch), 83, dev)
        for i in range(g):
            cols = slice(i * batch, (i + 1) * batch)
            assert rel(got[:, cols], kernels.ec_rmatmul(
                at[i], da[i], y[:, cols].contiguous(),
                yt[:, cols].contiguous())) <= 1e-6
    torch.cuda.synchronize()


def test_matmul_layout_is_one_wave_and_covers_the_pieces(cuda_device):
    """The forward launcher runs at most one wave of the resident slots it
    reports (one block a unit when there are fewer units), cuts the units
    -- (member, 16 rows, a 4,096-column piece of K) -- in equal shares,
    takes the staged kernel on 16-byte aligned images and register loads
    otherwise, and asks for a workspace that holds every unit's partial
    panel when K is more than one piece (none when it is one) and, for the
    staged kernel, x and x_tilde of every column packed."""
    from repro_torch.kernels.rram_mvm import matmul_layout
    dev = cuda_device
    big = torch.empty(32768, 32768, device=dev)
    stack = torch.empty(8, 16384, 4096, device=dev)
    cases = [(big, big, 1, 1, True), (big, big, 8, 1, True),
             (big[:, :16384], big[:, :16384], 1, 1, True),
             (big[:16384], big[:16384], 1, 1, True),
             (stack[:, :14336], stack[:, :14336], 1, 8, True),
             (stack[:, :14336], stack[:, :14336], 8, 8, True),
             (big[:5, :10], big[:5, :10], 3, 1, True),
             (big[:100, :4097], big[:100, :4097], 2, 1, True),
             (big[:100, 1:1001], big[:100, 1:1001], 1, 1, False),
             (big[:100, 1:8193], big[:100, 1:8193], 5, 1, False)]
    for at, da, batch, g, staged in cases:
        lay = matmul_layout(at, da, batch)
        m, k = at.shape[-2:]
        assert (lay.rows_per_unit, lay.cols_per_unit) == (16, 4096)
        pieces = max(1, -(-k // lay.cols_per_unit))
        assert lay.pieces == pieces
        assert lay.staged == staged
        assert lay.units == g * -(-m // lay.rows_per_unit) * pieces
        assert lay.blocks == min(lay.blocks_per_sm * lay.sms, lay.units)
        assert lay.sms == torch.cuda.get_device_properties(dev) \
            .multi_processor_count
        sizes = {hi - lo for lo, hi in _block_ranges(lay)}
        assert max(sizes) - min(sizes) <= 1
        partials = 0 if pieces == 1 else \
            lay.units * lay.rows_per_unit * batch
        assert lay.workspace_floats >= partials + \
            (2 * g * batch * k if staged else 0)
        if not staged:
            assert lay.workspace_floats == partials
    # The main path's images fill whole waves of the resident slots.
    lay = matmul_layout(big, big, 1)
    assert lay.blocks == lay.blocks_per_sm * lay.sms
    del big, stack


def _check_matmul(at, da, batch, seed, staged):
    """ec_matmul (or the grouped kernel on a (g, M, K) stack) on these
    views: the variant taken, against the plain version, run to run (20
    runs), a group of one against the solo call and, on a stack, every
    member against its solo call, bit for bit; returns the output."""
    from repro_torch.kernels.rram_mvm import matmul_layout
    dev = at.device
    g = at.shape[0] if at.ndim == 3 else 1
    k = at.shape[-1]
    x, xt = randn((k, g * batch), seed, dev), randn((k, g * batch), seed + 1,
                                                    dev)
    assert matmul_layout(at, da, min(batch, 8)).staged == staged
    if at.ndim == 2:
        run, plain = kernels.ec_matmul, kernels.ec_matmul_plain
    else:
        run, plain = kernels.ec_group_matmul, kernels.ec_group_matmul_plain
    kernels.reset_launches()
    got = run(at, da, x, xt)
    assert sum(kernels.LAUNCHES.values()) == -(-batch // 8)
    assert got.shape == (at.shape[-2], g * batch)
    assert rel(got, plain(at, da, x, xt)) <= 1e-5
    for _ in range(20):   # a stage refilled under a reader shows as a change
        assert torch.equal(got, run(at, da, x, xt))
    one = (at[:1], da[:1]) if at.ndim == 3 else (at[None], da[None])
    u, ut = x[:, :batch].contiguous(), xt[:, :batch].contiguous()
    assert torch.equal(kernels.ec_group_matmul(*one, u, ut),
                       kernels.ec_matmul(one[0][0], one[1][0], u, ut))
    for i in range(g if at.ndim == 3 else 0):
        cols = slice(i * batch, (i + 1) * batch)
        assert torch.equal(got[:, cols], kernels.ec_matmul(
            at[i], da[i], x[:, cols].contiguous(), xt[:, cols].contiguous()))
    return got


@pytest.mark.parametrize("batch", [1, 3, 8, 11])
@pytest.mark.parametrize("k", [1499, 4097])
def test_matmul_ragged_edges_both_variants(cuda_device, k, batch):
    """Ragged K (1,499; 4,097, which crosses a piece boundary: a sum pass
    adds two pieces) and M (4,097): through the staged kernel on a view of
    a padded image (row stride 1,504 or 4,104, 16-byte aligned; the tensor
    map's zero fill covers the edges) and through the register kernel on
    the contiguous image (row stride K) and on a view whose base is one
    float off 16 bytes.  The two kernels sum every row in the same order:
    on the same image they agree bit for bit."""
    dev = cuda_device
    m, lda = 4097, -(-k // 4) * 4 + 4
    pad = randn((m, lda), 70, dev), randn((m, lda), 71, dev)
    staged = _check_matmul(pad[0][:, :k], pad[1][:, :k], batch, 72,
                           staged=True)
    tight = pad[0][:, :k].contiguous(), pad[1][:, :k].contiguous()
    assert torch.equal(_check_matmul(*tight, batch, 72, staged=False),
                       staged)
    _check_matmul(pad[0][:, 1:1 + k], pad[1][:, 1:1 + k], batch, 76,
                  staged=False)
    torch.cuda.synchronize()


@pytest.mark.parametrize("batch", [1, 3, 8, 11])
@pytest.mark.parametrize("g", [3, 5, 8])
def test_group_matmul_units_straddle_members(cuda_device, g, batch):
    """Groups of 3, 5 and 8 ragged members (1,001 x 4,097 live views of
    padded stacks, two pieces of K each, and the same stacks with an
    unaligned base), whose blocks' unit ranges cross from one member into
    the next where the block count is not a multiple of g (where it is,
    members start on block boundaries): against the plain version, run to
    run, each member equal to its solo call bit for bit, and a group of one
    equal to the solo call bit for bit."""
    from repro_torch.kernels.rram_mvm import matmul_layout
    dev = cuda_device
    m, k = 1001, 4097
    stack = randn((g, m + 3, 4104), 80, dev), randn((g, m + 3, 4104), 81, dev)
    views = [(stack[0][:, :m, :k], stack[1][:, :m, :k], True),
             (stack[0][:, :m, 3:3 + k], stack[1][:, :m, 3:3 + k], False)]
    for at, da, staged in views:
        lay = matmul_layout(at, da, min(batch, 8))
        per_member = lay.units // g
        straddle = any(lo // per_member != (hi - 1) // per_member
                       for lo, hi in _block_ranges(lay))
        assert not (straddle and lay.blocks % g == 0)
        _check_matmul(at, da, batch, 82, staged)
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("batch", [1, 3, 8, 11])
def test_group_kernels_match_plain_and_solo(cuda_device, batch):
    """The grouped EC kernels on 8 ragged members: against their plain
    versions; one launch per 8 columns of every member (batch 11: two);
    member g equal to the solo kernel on member g (forward bit for bit; the
    transposed rows are cut for the whole group, so to rounding); a group
    of one equal to the solo kernel bit for bit."""
    dev = cuda_device
    g = 8
    for m, k in ((1000, 1500), (4100, 300)):
        at, da = randn((g, m, k), 40, dev), randn((g, m, k), 41, dev)
        x, xt = randn((k, g * batch), 42, dev), randn((k, g * batch), 43, dev)
        y, yt = randn((m, g * batch), 44, dev), randn((m, g * batch), 45, dev)
        kernels.reset_launches()
        p = kernels.ec_group_matmul(at, da, x, xt)
        q = kernels.ec_group_rmatmul(at, da, y, yt)
        assert kernels.LAUNCHES["ec_group_matmul"] == -(-batch // 8)
        assert kernels.LAUNCHES["ec_group_rmatmul"] == -(-batch // 8)
        assert rel(p, kernels.ec_group_matmul_plain(at, da, x, xt)) <= 1e-5
        assert rel(q, kernels.ec_group_rmatmul_plain(at, da, y, yt)) <= 1e-5
        for i in range(g):
            cols = slice(i * batch, (i + 1) * batch)
            u, ut = x[:, cols].contiguous(), xt[:, cols].contiguous()
            v, vt = y[:, cols].contiguous(), yt[:, cols].contiguous()
            assert torch.equal(p[:, cols], kernels.ec_matmul(at[i], da[i],
                                                             u, ut))
            assert rel(q[:, cols], kernels.ec_rmatmul(at[i], da[i], v, vt)) \
                <= 1e-6
        one = slice(0, batch)
        u, ut = x[:, one].contiguous(), xt[:, one].contiguous()
        v, vt = y[:, one].contiguous(), yt[:, one].contiguous()
        assert torch.equal(kernels.ec_group_matmul(at[:1], da[:1], u, ut),
                           kernels.ec_matmul(at[0], da[0], u, ut))
        assert torch.equal(kernels.ec_group_rmatmul(at[:1], da[:1], v, vt),
                           kernels.ec_rmatmul(at[0], da[0], v, vt))
    torch.cuda.synchronize()


@pytest.mark.parametrize("m,k,n,bk,bn", [(16, 40, 24, 8, 8),
                                         (20, 45, 50, 12, 20),
                                         (70, 100, 130, 24, 40),
                                         (130, 1100, 700, 512, 512),
                                         (1, 300, 250, 24, 40),
                                         (1, 256, 224, 512, 512),
                                         (600, 100, 228, 24, 40),
                                         (64, 70, 336, 12, 20),
                                         (40, 96, 300, 24, 50),
                                         (100, 64, 100, 16, 30)])
def test_encode_kernels_match_plain_versions(cuda_device, m, k, n, bk, bn):
    """``encode_matmul`` against its plain version on padded operands
    (ragged shapes; one row of x, fewer rows than the kernel's 256-row
    output tile and more than two of them; K not a multiple of its 16-row
    stages; MCA tiles of 12 and 24 rows that straddle stages; tile widths
    that do not divide its 112-column output tile; N below one output
    tile; W rows 16-byte aligned (N % 4 == 0) or not) and
    through ``rram_encode_matmul``; ``encode_matmul_rng`` against its plain
    version (the same Philox draws in torch integer ops) at sigma > 0,
    equal bit for bit to ``encode_matmul`` with zero eps at sigma = 0, and
    bit for bit from run to run."""
    from repro_torch.kernels import encode
    dev = cuda_device
    x, w, eps = randn((m, k), 50, dev), randn((k, n), 51, dev), \
        randn((k, n), 52, dev)
    kw = dict(sigma=0.17, levels=8, block_k=bk, block_n=bn)
    kernels.reset_launches()
    got = kernels.encode_matmul(x, w, eps, **kw)
    assert kernels.LAUNCHES["encode_matmul"] == 1
    xp, wp, ep = encode._pad_to(x, (1, bk)), encode._pad_to(w, (bk, bn)), \
        encode._pad_to(eps, (bk, bn))
    want = kernels.encode_matmul_plain(xp, wp, ep, 0.17, 8, bk, bn)[:m, :n]
    assert rel(got, want) <= 1e-5
    assert rel(kernels.rram_encode_matmul(x, w, eps, sigma=0.17, levels=8),
               kernels.rram_encode_matmul(x.cpu(), w.cpu(), eps.cpu(),
                                          sigma=0.17, levels=8).to(dev)) \
        <= 1e-5
    r = kernels.encode_matmul_rng(9, x, w, **kw)
    assert kernels.LAUNCHES["encode_matmul_rng"] == 1
    assert rel(r, kernels.encode_matmul_rng_plain(9, x, w, **kw)) <= 1e-5
    assert torch.equal(r, kernels.encode_matmul_rng(9, x, w, **kw))
    zero = dict(kw, sigma=0.0)
    assert torch.equal(kernels.encode_matmul_rng(9, x, w, **zero),
                       kernels.encode_matmul(x, w, torch.zeros_like(w),
                                             **zero))
    torch.cuda.synchronize()


def _encoded_reference(w, eps, sigma, levels, bk, bn):
    """Q(w) * (1 + sigma * eps) for (bk, bn) MCA tiles in numpy float32, one
    IEEE operation at a time in the reference's order: the bits the kernel
    must produce."""
    f32 = np.float32
    k, n = w.shape
    out = np.empty_like(w)
    lm1 = f32(levels - 1)
    for r in range(0, k, bk):
        for c in range(0, n, bn):
            t = w[r:r + bk, c:c + bn]
            scale = np.abs(t).max()
            scale = f32(1.0) if scale == 0 else scale
            q = np.rint(t / scale * lm1) / lm1 * scale
            out[r:r + bk, c:c + bn] = q * (f32(1.0) + f32(sigma)
                                           * eps[r:r + bk, c:c + bn])
    return out


def test_encode_kernel_quantizes_bit_for_bit(cuda_device):
    """x = I reads the encoded weights back: eye(k) @ encode(w) equals
    Q(w) * (1 + sigma * eps) computed one IEEE float32 operation at a time
    (no bin flips), bit for bit, on MCA tiles holding zeros of both signs,
    subnormals, values one ulp around the bins' half-way points, an
    all-zero tile and tiles scaled by 2^70 and 2^-70 (outside the
    branch-free quantizer's range, so the IEEE divisions run)."""
    dev = cuda_device
    k, n, bk, bn, levels, sigma = 64, 200, 16, 40, 8, 0.3
    rng = np.random.default_rng(56)
    w = rng.standard_normal((k, n)).astype(np.float32)
    eps = rng.standard_normal((k, n)).astype(np.float32)
    flat = w[:16, :40].reshape(-1)  # tile (0, 0): special values
    flat[:40] = 0.0
    flat[40:80] = -0.0
    flat[80:100] = np.float32(1e-40)
    flat[100:120] = np.float32(-3e-39)
    scale = np.abs(w[:16, :40]).max()
    for i, m in enumerate(range(-6, 7)):
        half = np.float32((m + 0.5) / 7.0) * scale
        flat[200 + 3 * i:203 + 3 * i] = [np.nextafter(half, -np.inf), half,
                                         np.nextafter(half, np.inf)]
    w[:16, :40] = flat.reshape(16, 40)
    w[16:32, 40:80] = 0.0
    w[32:48, 80:120] *= np.float32(2.0 ** 70)
    w[48:64, 120:160] *= np.float32(2.0 ** -70)
    want = _encoded_reference(w, eps, sigma, levels, bk, bn)
    got = kernels.encode_matmul(torch.eye(k, device=dev),
                                torch.from_numpy(w).to(dev),
                                torch.from_numpy(eps).to(dev), sigma=sigma,
                                levels=levels, block_k=bk, block_n=bn)
    assert np.array_equal(got.cpu().numpy(), want)


def test_encode_rng_kernel_row_blocks_agree(cuda_device):
    """``encode_matmul_rng`` on x of 600 rows (three 256-row tiles, the last
    one short) equals, row block by row block, the kernel on each slice of
    x, bit for bit: the draws are keyed by the weight tile, so every row
    tile encodes the same W_tilde and sums it in the same order."""
    dev = cuda_device
    x, w = randn((600, 200), 53, dev), randn((200, 260), 54, dev)
    kw = dict(sigma=0.4, levels=8, block_k=24, block_n=40)
    whole = kernels.encode_matmul_rng(17, x, w, **kw)
    for lo, hi in ((0, 256), (256, 512), (512, 600), (100, 350), (599, 600)):
        assert torch.equal(kernels.encode_matmul_rng(17, x[lo:hi].contiguous(),
                                                     w, **kw), whole[lo:hi])
    torch.cuda.synchronize()


def test_encode_workspace_query(cuda_device):
    """The launcher's size queries: one scale per MCA tile, and x transposed
    and zero-padded to whole 16-row stages and 256-row tiles."""
    from repro_torch.kernels import encode
    dev = cuda_device
    assert encode._workspace_floats(256, 4096, 14336, 512, 512, dev) == \
        (8 * 28, 4096 * 256)
    assert encode._workspace_floats(600, 100, 228, 24, 40, dev) == \
        (5 * 6, 112 * 768)
    assert encode._workspace_floats(1, 1, 1, 1, 1, dev) == (1, 16 * 256)
    assert encode._workspace_floats(0, 64, 8, 8, 8, dev) == (8, 0)


def test_encode_rng_kernel_noise_moments(cuda_device):
    """The in-kernel draws read back through the product: W of ones is
    quantized to ones, so ``eye @ encode(W) = 1 + sigma * eta``; 2^20
    draws have mean 0 and variance 1 (within 0.01 and 2 %)."""
    dev = cuda_device
    k, n, sigma = 512, 2048, 0.5
    eye, w = torch.eye(k, device=dev), torch.ones(k, n, device=dev)
    eta = (kernels.encode_matmul_rng(21, eye, w, sigma=sigma, levels=8) - 1.0) \
        / sigma
    assert abs(float(eta.mean())) <= 0.01
    assert abs(float(eta.var()) - 1.0) <= 0.02


@pytest.mark.parametrize("method", ["neumann", "thomas"])
def test_group_engine_on_card_is_one_launch_and_matches_cpu(cuda_device,
                                                            method):
    """A group of 8 on the card: each ``group_mvm`` / ``group_rmvm`` at
    batch <= 8 is exactly one grouped EC launch and one tier-2 launch, and
    equals the same backend on the CPU with the same injected draws; each
    member equals its solo ``member(g)`` execute under the same key."""
    from repro_torch.core.prng import fold_in
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 64, 64),
                         denoise_method=method, lam=1e-2)
    a = randn((8, 300, 260), 60, "cpu")
    cpu = AnalogEngine(cfg, backend="cuda", device="cpu")
    G = cpu.program_group(a, 3)
    gpu = AnalogEngine(cfg, backend="cuda", device=cuda_device)
    H = gpu.group([AnalogMatrix(engine=gpu, shape=G.shape, base_key=k,
                                write_stats=G.member(i).write_stats,
                                at_pad=G.at_pad[i].to(cuda_device),
                                da_pad=G.da_pad[i].to(cuda_device))
                   for i, k in enumerate(G.member_keys)])
    tier2 = "thomas_solve" if method == "thomas" else "stencil_denoise"
    for transpose, rows, cols in ((False, 260, 300), (True, 300, 260)):
        for batch in (1, 8):
            u = randn((8, rows, batch), 61, "cpu")
            pad = G.at_pad.shape[1 if transpose else 2]
            eta = randn((8, pad, batch), 62, "cpu")
            run_gpu = gpu.group_rmvm if transpose else gpu.group_mvm
            run_cpu = cpu.group_rmvm if transpose else cpu.group_mvm
            kernels.reset_launches()
            got = run_gpu(H, u.to(cuda_device), eta=eta.to(cuda_device))
            name = "ec_group_rmatmul" if transpose else "ec_group_matmul"
            assert kernels.LAUNCHES[name] == 1
            assert kernels.LAUNCHES[tier2] == 1
            assert sum(kernels.LAUNCHES.values()) == 2
            assert got.shape == (8, cols, batch)
            assert rel(got.cpu(), run_cpu(G, u, eta=eta)) <= 1e-5
            keyed = run_gpu(H, u.to(cuda_device), key=5)
            solo = gpu.rmvm if transpose else gpu.mvm
            for i in range(8):
                assert rel(keyed[i], solo(H.member(i), u[i].to(cuda_device),
                                          key=fold_in(5, i))) <= 1e-6


def test_chain_on_card_is_a_loop_of_block_launches(cuda_device):
    """``chain_mvm`` on the card: one ``ec_matmul`` launch per capacity
    block per member, and the same result as the CPU path under the same
    draws."""
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 64, 64))
    a = randn((4, 200, 200), 63, "cpu") / 200 ** 0.5
    cpu = AnalogEngine(cfg, backend="cuda", device="cpu")
    G = cpu.program_group(a, 4)
    gpu = AnalogEngine(cfg, backend="cuda", device=cuda_device)
    H = gpu.group([AnalogMatrix(engine=gpu, shape=G.shape, base_key=k,
                                write_stats=G.member(i).write_stats,
                                at_pad=G.at_pad[i].to(cuda_device),
                                da_pad=G.da_pad[i].to(cuda_device))
                   for i, k in enumerate(G.member_keys)])
    h = randn((200, 2), 64, "cpu")
    eta = randn((4, 2, 2, 128, 2), 65, "cpu")
    kernels.reset_launches()
    got = gpu.chain_mvm(H, h.to(cuda_device), activation="relu",
                        eta=eta.to(cuda_device))
    assert kernels.LAUNCHES["ec_matmul"] == 4 * 2 * 2
    assert rel(got.cpu(), cpu.chain_mvm(G, h, activation="relu",
                                        eta=eta)) <= 1e-5
