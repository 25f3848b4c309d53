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
from repro_torch.solvers.registry import RUN, contract_config

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


@pytest.mark.parametrize("n", [1, 2, 1000, 32768, 65025])
def test_thomas_scan_kernel_matches_plain(cuda_device, n):
    """The block-scan kernel against the sequential plain version at
    rel-L2 <= 1e-6 for lam in {1e-12, 1e-2, 0.5, 10} and batch in {1, 3,
    8, 64} (one block a column; 65,025 rows walk two tiles of 32,768), bit
    for bit run to run, one launch a call; the plain version runs once per
    lam on the widest panel (its columns are independent)."""
    p = randn((n, 64), 26, cuda_device)
    for lam in (1e-12, 1e-2, 0.5, 10.0):
        want = kernels.thomas_solve_plain(p, lam)
        for batch in (1, 3, 8, 64):
            q = p[:, :batch].contiguous()
            kernels.reset_launches()
            got = kernels.thomas_solve(q, lam)
            assert kernels.LAUNCHES["thomas_solve"] == 1
            assert got.shape == (n, batch)
            assert rel(got, want[:, :batch]) <= 1e-6
            assert torch.equal(got, kernels.thomas_solve(q, lam))
        if lam >= 0.5 and n > 1:
            assert rel(got, q) > 1e-2
    torch.cuda.synchronize()


def test_thomas_kernel_unaligned_column(cuda_device):
    """A one-column panel that starts 4 bytes past a 16-byte boundary goes
    through the transposed workspace, as a wider panel does: equal to the
    aligned call bit for bit."""
    p = randn((1001, 1), 28, cuda_device)
    q = torch.cat([p.new_zeros(1), p[:, 0]])[1:, None]
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    assert torch.equal(kernels.thomas_solve(q, 0.5),
                       kernels.thomas_solve(p, 0.5))


@pytest.mark.parametrize("n,batch", [(5000, 3), (32768, 8), (65025, 1)])
def test_thomas_scan_kernel_at_large_lam_against_fp64(cuda_device, n, batch):
    """At lam = 1e3 (|c'| ~ 0.97) the kernel's error against a float64
    solve is at most twice the plain version's: a scan that cut a carry
    short would miss by orders of magnitude."""
    p = randn((n, batch), 27, cuda_device)
    want = kernels.tridiag.thomas_solve_fp64(p, 1e3)
    got = kernels.thomas_solve(p, 1e3)
    assert torch.equal(got, kernels.thomas_solve(p, 1e3))
    assert rel(got, want) <= 2 * rel(kernels.thomas_solve_plain(p, 1e3), want)


@pytest.mark.parametrize("n,batch", [(5000, 3), (32768, 1)])
def test_thomas_kernel_with_a_long_coefficient_head(cuda_device, n, batch):
    """At lam = 1e6 the coefficients reach their fixed point only after
    1,846 rows, so 29 chunks of 64 rows (across warps) read theirs from
    memory: the error against a float64 solve stays within twice the plain
    version's, bit for bit run to run."""
    assert kernels.tridiag.thomas_tail(n, 1e6, -1.0)[0] > 1800
    p = randn((n, batch), 29, cuda_device)
    want = kernels.tridiag.thomas_solve_fp64(p, 1e6)
    got = kernels.thomas_solve(p, 1e6)
    assert torch.equal(got, kernels.thomas_solve(p, 1e6))
    assert rel(got, want) <= 2 * rel(kernels.thomas_solve_plain(p, 1e6), want)


# ------------------------- stencil_denoise and cg_update (PDL launches)
# The main path's tier-2 panels: the solvers' columns, their batch 8,
# qwen3-1.7b's (d_out, rows) panels at decode (4) and prefill (1,024) rows,
# and [13b]'s MoE (F, E * C) panel at 256 tokens.
STENCIL_SHAPES = [(32768, 1), (32768, 8), (16384, 1), (65025, 1), (2048, 4),
                  (6144, 4), (151936, 4), (6144, 1024), (151936, 1024),
                  (14336, 640)]
CG_SHAPES = [(32768, 1), (32768, 8), (65025, 1)]


def offset_panel(n, batch, seed, dev):
    """A contiguous (n, batch) view that starts 4 bytes past a 16-byte
    boundary (the kernels' scalar path), and the same values aligned."""
    p = randn((n, batch), seed, dev)
    buf = torch.empty(n * batch + 4, device=dev)
    q = buf[1:1 + n * batch].view(n, batch)
    q.copy_(p)
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    return q, p


def finish_within(seconds, what):
    """Waits for the work queued on the stream, failing after ``seconds``
    (a kernel that waits on itself would hang the stream)."""
    import time
    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while not done.query():
        assert time.monotonic() - t0 < seconds, \
            f"{what}: no finish in {seconds} s"
        time.sleep(1e-3)


@pytest.mark.parametrize("n,batch", STENCIL_SHAPES,
                         ids=[f"{n}x{b}" for n, b in STENCIL_SHAPES])
def test_stencil_matches_plain_at_main_path_shapes(cuda_device, n, batch):
    """``stencil_denoise`` at the main path's shapes, lam 1e-12 (the
    engine's) and 1e-2: within 1e-6 rel-L2 of its plain version, one launch
    a call, bit for bit run to run."""
    p = randn((n, batch), 140, cuda_device)
    for lam in (1e-12, 1e-2):
        kernels.reset_launches()
        got = kernels.stencil_denoise(p, lam)
        assert kernels.LAUNCHES["stencil_denoise"] == 1
        assert got.shape == (n, batch)
        assert rel(got, kernels.stencil_denoise_plain(p, lam)) <= 1e-6
        assert torch.equal(got, kernels.stencil_denoise(p, lam))
    assert rel(got, p) > 1e-3
    torch.cuda.synchronize()


@pytest.mark.parametrize("batch", [1, 3, 4, 9])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 1001])
def test_stencil_small_ragged_and_offset_panels(cuda_device, n, batch):
    """Short columns (the float4 tail, the warp's edge words), widths not a
    multiple of 4 and a view at a 4-byte offset (the scalar paths): within
    1e-6 of the plain version; the offset view equals the aligned panel bit
    for bit."""
    q, p = offset_panel(n, batch, 141, cuda_device)
    for lam in (1e-2, 0.3):
        want = kernels.stencil_denoise_plain(p, lam)
        got = kernels.stencil_denoise(p, lam)
        assert rel(got, want) <= 1e-6
        assert torch.equal(got, kernels.stencil_denoise(p, lam))
        assert torch.equal(kernels.stencil_denoise(q, lam), got)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,batch", CG_SHAPES + [(1, 1), (2, 3), (3, 4),
                                                 (5, 9), (1001, 1),
                                                 (1001, 3)])
def test_cg_update_matches_plain(cuda_device, n, batch):
    """``cg_update`` at the solvers' shapes and on short and ragged panels:
    within 1e-6 of its plain version, one launch a call, bit for bit run to
    run; on views at a 4-byte offset equal to the aligned call."""
    views = [offset_panel(n, batch, 150 + s, cuda_device) for s in range(4)]
    v = [p for _, p in views]
    alpha = randn((batch,), 155, cuda_device)
    kernels.reset_launches()
    got = kernels.cg_update(*v, alpha)
    assert kernels.LAUNCHES["cg_update"] == 1
    for g, w in zip(got, kernels.cg_update_plain(*v, alpha)):
        assert g.shape == (n, batch) and rel(g, w) <= 1e-6
    for g, w in zip(got, kernels.cg_update(*v, alpha)):
        assert torch.equal(g, w)
    for g, w in zip(kernels.cg_update(*[q for q, _ in views], alpha), got):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


def test_stencil_after_ec_rmatmul_back_to_back(cuda_device):
    """PDL: a stencil launched on ``ec_rmatmul``'s output (the LM dense's
    pair) and a stencil on a stencil's output (one PDL kernel after
    another), 20 times back to back, equal the same calls with the stream
    synchronised between the two."""
    dev = cuda_device
    at, da = randn((2048, 6144), 160, dev), randn((2048, 6144), 161, dev)
    y, yt = randn((2048, 8), 162, dev), randn((2048, 8), 163, dev)
    want = []
    for _ in range(2):
        p = kernels.ec_rmatmul(at, da, y, yt)
        torch.cuda.synchronize()
        q = kernels.stencil_denoise(p, 1e-2)
        torch.cuda.synchronize()
        want.append((q, kernels.stencil_denoise(q, 0.3)))
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*want))
    got = []
    for _ in range(20):
        q = kernels.stencil_denoise(kernels.ec_rmatmul(at, da, y, yt), 1e-2)
        got.append((q, kernels.stencil_denoise(q, 0.3)))
    finish_within(60, "ec_rmatmul + stencil_denoise x 20")
    for q, r in got:
        assert torch.equal(q, want[0][0]) and torch.equal(r, want[0][1])


def test_cg_update_after_its_reduction_back_to_back(cuda_device):
    """PDL: ``cg_update`` reading the alpha that a torch reduction writes
    just before it, 20 iterations back to back (each iteration's outputs the
    next one's inputs), equal the same iterations synchronised between the
    reduction and the update."""
    dev = cuda_device
    n, batch = 32768, 8
    p, ap = randn((n, batch), 170, dev), randn((n, batch), 171, dev)

    def run(sync):
        x, r = torch.zeros(n, batch, device=dev), randn((n, batch), 172, dev)
        out = []
        for _ in range(20):
            alpha = torch.sum(r * r, dim=0) / torch.clamp(
                torch.sum(p * ap, dim=0), min=1e-30)
            if sync:
                torch.cuda.synchronize()
            x, r = kernels.cg_update(x, r, p, ap, alpha)
            if sync:
                torch.cuda.synchronize()
            out.append((x, r))
        return out

    want = run(True)
    got = run(False)
    finish_within(60, "reduction + cg_update x 20")
    for (gx, gr), (wx, wr) in zip(got, want):
        assert torch.equal(gx, wx) and torch.equal(gr, wr)


@pytest.mark.parametrize("n,batch", [(65025, 1), (151936, 64), (6144, 1024)])
def test_stencil_chain_on_recycled_blocks(cuda_device, n, batch):
    """PDL with the caching allocator recycling blocks: 20 stencils, each
    output the next one's input and dropped after it, so that output k + 1
    takes the block of input k while the kernel before it on the stream may
    still read it; equals the same chain synchronised between calls."""
    p = randn((n, batch), 180, cuda_device)

    def chain(sync):
        y, ptrs = p, []
        for _ in range(20):
            y = kernels.stencil_denoise(y, 0.3)
            ptrs.append(y.data_ptr())
            if sync:
                torch.cuda.synchronize()
        return y, ptrs

    want, _ = chain(True)
    got, ptrs = chain(False)
    finish_within(60, "stencil_denoise chain x 20")
    assert any(a == b for a, b in zip(ptrs[2:], ptrs))
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,batch", [(65025, 1), (32768, 8)])
def test_cg_update_chain_on_recycled_blocks(cuda_device, n, batch):
    """PDL with the caching allocator recycling blocks: 20 CG updates, each
    (x, r) the next one's input and dropped after it, alpha from a torch
    reduction before each; equals the same chain synchronised between
    calls."""
    dev = cuda_device
    p, ap = randn((n, batch), 185, dev), randn((n, batch), 186, dev)

    def chain(sync):
        x, r = torch.zeros(n, batch, device=dev), randn((n, batch), 187, dev)
        ptrs = []
        for _ in range(20):
            alpha = 0.1 * torch.sum(r * r, dim=0) / torch.clamp(
                torch.sum(p * ap, dim=0).abs(), min=1e-30)
            if sync:
                torch.cuda.synchronize()
            x, r = kernels.cg_update(x, r, p, ap, alpha)
            ptrs.append(x.data_ptr())
            if sync:
                torch.cuda.synchronize()
        return x, r, ptrs

    wx, wr, _ = chain(True)
    gx, gr, ptrs = chain(False)
    finish_within(60, "reduction + cg_update chain x 20")
    assert any(a == b for a, b in zip(ptrs[2:], ptrs))
    assert torch.equal(gx, wx) and torch.equal(gr, wr)


# -------------------- richardson_update (PDL launch) and the floor probe
# The solvers' columns and short, ragged panels: the vector's partial last
# unit (n = 1, 3, 5, 4,097) and widths not a multiple of 4.
RICHARDSON_SHAPES = CG_SHAPES + [(n, b) for n in (1, 3, 5, 4097)
                                 for b in (1, 3, 5, 8)]


@pytest.mark.parametrize("n,batch", RICHARDSON_SHAPES,
                         ids=[f"{n}x{b}" for n, b in RICHARDSON_SHAPES])
def test_richardson_update_matches_plain(cuda_device, n, batch):
    """``richardson_update`` at the solvers' shapes and on short and ragged
    panels: within 1e-6 of its plain version, the residual exactly b - y,
    one launch a call, bit for bit run to run; on views at a 4-byte offset
    (the scalar path) equal to the aligned call."""
    views = [offset_panel(n, batch, 190 + s, cuda_device) for s in range(3)]
    v = [p for _, p in views]
    omega = torch.tensor(0.37, device=cuda_device)
    kernels.reset_launches()
    got = kernels.richardson_update(*v, omega)
    assert kernels.LAUNCHES["richardson_update"] == 1
    for g, w in zip(got, kernels.richardson_update_plain(*v, omega)):
        assert g.shape == (n, batch) and rel(g, w) <= 1e-6
    assert torch.equal(got[1], v[1] - v[2])
    for g, w in zip(kernels.richardson_update(*v, omega), got):
        assert torch.equal(g, w)
    for g, w in zip(kernels.richardson_update(*[q for q, _ in views], omega),
                    got):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


@pytest.mark.parametrize("batch", [1, 8])
def test_richardson_update_after_stencil_and_omega_back_to_back(cuda_device,
                                                                batch):
    """PDL: ``richardson_update`` as the Richardson solve runs it, on the
    stencil of an ``ec_matmul`` launched just before it and with an omega
    that torch reductions compute on the device just before, 20 iterations
    back to back (each x the next product's input), equals the same
    iterations synchronised between the kernels."""
    dev = cuda_device
    n = 4096
    at, da = randn((n, n), 196, dev) / n, randn((n, n), 197, dev) / n
    b = randn((n, batch), 198, dev)

    def run(sync):
        x, out = torch.zeros(n, batch, device=dev), []
        for _ in range(20):
            y = kernels.stencil_denoise(kernels.ec_matmul(at, da, x, x), 1e-2)
            om = 0.5 / (1.0 + torch.linalg.vector_norm(y) / n)
            if sync:
                torch.cuda.synchronize()
            x, r = kernels.richardson_update(x, b, y, om)
            if sync:
                torch.cuda.synchronize()
            out.append((x, r))
        return out

    want = run(True)
    got = run(False)
    finish_within(60, "ec_matmul + stencil + richardson_update x 20")
    for (gx, gr), (wx, wr) in zip(got, want):
        assert torch.equal(gx, wx) and torch.equal(gr, wr)


@pytest.mark.parametrize("n,batch", [(65025, 1), (32768, 8)])
def test_richardson_update_chain_on_recycled_blocks(cuda_device, n, batch):
    """PDL with the caching allocator recycling blocks: 20 Richardson
    updates, each (x, r) the next one's (x, y) and dropped after it, omega
    from a torch reduction before each; equals the same chain synchronised
    between calls."""
    dev = cuda_device
    b = randn((n, batch), 200, dev)

    def chain(sync):
        x, r = torch.zeros(n, batch, device=dev), randn((n, batch), 201, dev)
        ptrs = []
        for _ in range(20):
            om = 0.5 / (1.0 + torch.sum(r * r) / r.numel())
            if sync:
                torch.cuda.synchronize()
            x, r = kernels.richardson_update(x, b, r, om)
            ptrs.append(x.data_ptr())
            if sync:
                torch.cuda.synchronize()
        return x, r, ptrs

    wx, wr, _ = chain(True)
    gx, gr, ptrs = chain(False)
    finish_within(60, "reduction + richardson_update chain x 20")
    assert any(a == b for a, b in zip(ptrs[2:], ptrs))
    assert torch.equal(gx, wx) and torch.equal(gr, wr)


def test_launch_floor_probe_launches_plain(cuda_device):
    """The floor probe writes 1.0 with a plain launch and counts nothing:
    launched on the last element of a stencil's output, just after the
    stencil (a PDL kernel that lets the next one be scheduled before its
    stores), its write lands after the stencil's, 20 times of 20; the rest
    of the output is the stencil's."""
    p = randn((65025, 1), 202, cuda_device)
    want = kernels.stencil_denoise(p, 0.3)
    kernels.reset_launches()
    outs = []
    for _ in range(20):
        y = kernels.stencil_denoise(p, 0.3)
        assert kernels.launch_floor_probe(y[-1:]).data_ptr() == \
            y[-1:].data_ptr()
        outs.append(y)
    finish_within(60, "stencil_denoise + launch_floor_probe x 20")
    assert kernels.LAUNCHES["stencil_denoise"] == 20
    assert sum(kernels.LAUNCHES.values()) == 20
    for y in outs:
        assert float(y[-1, 0]) == 1.0 and torch.equal(y[:-1], want[:-1])

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


def _card_copy(A, engine):
    """The CPU handle ``A``'s image on ``engine``'s card."""
    return AnalogMatrix(engine=engine, shape=A.shape, base_key=A.base_key,
                        write_stats=A.write_stats,
                        at_pad=A.at_pad.to(engine.device),
                        da_pad=A.da_pad.to(engine.device))


@pytest.mark.parametrize("method", ["neumann", "thomas"])
def test_krylov_and_refine_on_card_match_cpu(cuda_device, method):
    """BiCGSTAB, GMRES(5) and refine (CG and Richardson inner) on one image,
    DAC off (so each MVM is a function of the image alone): ``backend=
    "cuda"`` on the card takes the iterations of the same solve on CPU
    tensors, x within 1e-5; every MVM is one ``ec_matmul`` and one tier-2
    launch, and refine's inner loops launch their update kernels."""
    from repro_torch.core import rel_l2
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 64, 64), encode_inputs=False,
                         denoise_method=method, lam=1e-2)
    n = 200
    r = randn((n, n), 70, "cpu") / n ** 0.5
    nonsym = 2.0 * torch.eye(n) + 0.6 * r
    spd = (r + r.T) / n ** 0.5 + 2.0 * torch.eye(n)
    b = randn((n, 3), 71, "cpu")
    cpu = AnalogEngine(cfg, backend="cuda", device="cpu")
    gpu = AnalogEngine(cfg, backend="cuda", device=cuda_device)
    tier2 = "thomas_solve" if method == "thomas" else "stencil_denoise"
    runs = [
        (nonsym, lambda A, u: solvers.bicgstab(A, u, tol=1e-5, maxiter=60),
         None),
        (nonsym, lambda A, u: solvers.gmres(A, u, restart=5, tol=1e-5,
                                            maxiter=40), None),
        (spd, lambda A, u: solvers.refine(A, u, inner="cg", tol=1e-5,
                                          backend="cuda"), "cg_update"),
        (spd, lambda A, u: solvers.refine(A, u, inner="richardson",
                                          omega=0.5, tol=1e-5,
                                          backend="cuda"),
         "richardson_update")]
    for a, solve, update in runs:
        A = cpu.program(a, 9)
        want = solve(A, b)
        kernels.reset_launches()
        got = solve(_card_copy(A, gpu), b.to(cuda_device))
        torch.cuda.synchronize()
        assert got.converged and want.converged, (got, want)
        assert got.iterations == want.iterations
        assert got.ledger.mvms == want.ledger.mvms
        assert float(rel_l2(got.x.cpu(), want.x)) <= 1e-5
        assert kernels.LAUNCHES["ec_matmul"] == got.ledger.mvms
        assert kernels.LAUNCHES[tier2] == got.ledger.mvms
        if update is not None:
            assert kernels.LAUNCHES[update] > 0


def test_quickstart_image_takes_the_register_load_layout(cuda_device):
    """The 66^2 image of the quickstart (MCAGeometry(1, 1, 66, 66): a
    264-byte row stride, not 16-byte aligned) runs ``ec_matmul`` on the
    register-load layout, equal to its plain version at batch 1 and 8 and
    the same run to run; the engine's MVM on it launches once."""
    from repro_torch.core.matrices import paper_matrix
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(1, 1, 66, 66))
    eng = AnalogEngine(cfg, backend="cuda", device=cuda_device)
    a = torch.from_numpy(paper_matrix("bcsstk02").astype(np.float32))
    A = eng.program(a.to(cuda_device), 1)
    at, da = A.at_pad, A.da_pad
    assert at.shape == (66, 66) and at.stride(0) * 4 == 264
    for batch in (1, 8):
        lay = kernels.matmul_layout(at, da, batch)
        assert not lay.staged
        x = randn((66, batch), 72, cuda_device)
        xt = x * (1 + 0.01 * randn((66, batch), 73, cuda_device))
        got = kernels.ec_matmul(at, da, x, xt)
        assert rel(got, kernels.ec_matmul_plain(at, da, x, xt)) <= 1e-5
        assert torch.equal(got, kernels.ec_matmul(at, da, x, xt))
    kernels.reset_launches()
    y = A @ randn((66,), 74, cuda_device)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ec_matmul"] == 1 and y.shape == (66,)


@pytest.mark.parametrize("batch", [None, 4])
def test_corrected_mvm_on_card_is_the_reference_engine(cuda_device, batch):
    """The one-shot ``corrected_mvm`` on CUDA tensors equals the
    ``reference``-backend engine's program + first mvm under the same key,
    bit for bit, and bills program + one input write."""
    from repro_torch.core import corrected_mvm
    from repro_torch.core.matrices import paper_matrix
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(1, 1, 66, 66))
    a = torch.from_numpy(paper_matrix("bcsstk02").astype(np.float32)) \
        .to(cuda_device)
    x = randn((66,) if batch is None else (66, batch), 75, cuda_device)
    y, stats = corrected_mvm(a, x, 11, cfg)
    A = AnalogEngine(cfg, backend="reference", device=cuda_device) \
        .program(a, 11)
    assert y.device.type == "cuda" and torch.equal(y, A @ x)
    assert stats.energy_j == pytest.approx(
        A.write_stats.energy_j + A.input_write_stats(batch or 1).energy_j,
        rel=1e-12)


def _streamed_pair(cfg, a, dev, eta):
    """The same producer over ``a`` programmed on the CPU and on ``dev``
    with one injected programming draw."""
    cap_m, cap_n = cfg.geom.capacity
    mb, nb = -(-a.shape[0] // cap_m), -(-a.shape[1] // cap_n)
    pad = torch.zeros(mb * cap_m, nb * cap_n)
    pad[:a.shape[0], :a.shape[1]] = a
    blocks = pad.view(mb, cap_m, nb, cap_n).permute(0, 2, 1, 3)
    out = []
    for d in ("cpu", dev):
        eng = AnalogEngine(cfg, execution="streamed", backend="cuda",
                           device=d)
        out.append(eng.program(lambda i, j: blocks[i, j], 3, shape=a.shape,
                               eta=eta.to(d)))
    return out, (mb, nb)


@pytest.mark.parametrize("method", ["neumann", "thomas"])
@pytest.mark.parametrize("transpose", [False, True])
def test_streamed_engine_on_card_matches_cpu_path(cuda_device, transpose,
                                                  method):
    """A streamed handle on the card: one ``ec_matmul`` (``ec_rmatmul``)
    launch per capacity block on the block and its derived dA, one tier-2
    launch on the assembled output, equal to the same backend on the CPU
    (plain versions) under the same injected draws."""
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 64, 64), lam=1e-2,
                         denoise_method=method)
    a = randn((300, 260), 90, "cpu")
    eta = randn((3, 3, 128, 128), 91, "cpu")
    (C, G), (mb, nb) = _streamed_pair(cfg, a, cuda_device, eta)
    assert rel(G.at_stack.cpu(), C.at_stack) <= 1e-6
    u = randn((300 if transpose else 260, 4), 92, "cpu")
    dac = randn((mb, nb, 128, 4), 93, "cpu")
    kernels.reset_launches()
    run = G.engine.rmvm if transpose else G.engine.mvm
    got = run(G, u.to(cuda_device), eta=dac.to(cuda_device))
    torch.cuda.synchronize()
    name = "ec_rmatmul" if transpose else "ec_matmul"
    tier2 = "thomas_solve" if method == "thomas" else "stencil_denoise"
    assert kernels.LAUNCHES[name] == mb * nb
    assert kernels.LAUNCHES[tier2] == 1
    want = (C.engine.rmvm if transpose else C.engine.mvm)(C, u, eta=dac)
    assert rel(got.cpu(), want) <= 1e-5


def test_streamed_block_stack_passes_the_image_check(cuda_device):
    """Every block of a streamed image stack and a freshly derived dA share
    the row stride cap_n, so the EC kernels take both as they are (no copy
    of the block) and agree with their plain versions."""
    from repro_torch.kernels._checks import check_images
    from repro_torch.core.matrices import ImplicitBandedMatrix
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 256, 256))
    imp = ImplicitBandedMatrix(n=1300, cap_m=512, cap_n=512, seed=4,
                               device=cuda_device)
    A = AnalogEngine(cfg, execution="streamed", backend="cuda",
                     device=cuda_device).program(imp.block, 1,
                                                 shape=(1300, 1300))
    for i, j in ((0, 0), (1, 2), (2, 2)):
        at_blk = A.at_blocks[i, j]
        da_blk = imp.block(i, j) - at_blk
        check_images("ec_matmul", at_blk, da_blk, at_blk.device)
        assert at_blk.stride() == da_blk.stride() == (512, 1)
        u = randn((512, 2), 94, cuda_device)
        assert rel(kernels.ec_matmul(at_blk, da_blk, u, 1.01 * u),
                   kernels.ec_matmul_plain(at_blk, da_blk, u, 1.01 * u)) \
            <= 1e-5


def test_streamed_peak_memory_bound(cuda_device):
    """At 10,000^2 over 2,048^2 blocks (5 x 5, taox-hfox, EC on): a resident
    streamed MVM adds at most 12 capacity blocks over its image, and the
    one-shot ``streamed_corrected_mvm`` holds under 12 blocks with no
    image; both are close to the ground-truth oracle."""
    from repro_torch.core import streamed_corrected_mvm
    from repro_torch.core.matrices import ImplicitBandedMatrix
    n, cap = 10000, 2048
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(4, 4, 512, 512))
    block = cap * cap * 4
    imp = ImplicitBandedMatrix(n=n, cap_m=cap, cap_n=cap, seed=5,
                               device=cuda_device)
    x = randn((n,), 95, cuda_device)
    want = imp.matvec(x)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    A = AnalogEngine(cfg, execution="streamed", backend="cuda",
                     device=cuda_device).program(imp.block, 2, shape=(n, n))
    assert A.image_nbytes == 25 * block
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    y = A @ x
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= \
        A.image_nbytes + 12 * block
    assert rel(y, want) < 0.05
    del A
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    y1, _ = streamed_corrected_mvm(imp.block, x, n, n, 2, cfg)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 12 * block
    assert rel(y1, want) < 0.05


def _separated_spd(n, seed):
    """Q diag(lam) Q' with two separated eigenvalues at each end of [1, 2]."""
    q, _ = torch.linalg.qr(randn((n, n), seed, "cpu").double())
    lam = torch.cat([torch.tensor([1.0, 1.1]),
                     torch.linspace(1.25, 1.75, n - 4),
                     torch.tensor([1.9, 2.0])]).double()
    a = (q * lam[None, :]) @ q.T
    return (0.5 * (a + a.T)).float()


@pytest.mark.parametrize("method", ["neumann", "thomas"])
def test_eigen_solvers_on_card_backends_agree(cuda_device, method):
    """Lanczos, LOBPCG (k = 2, both ends) and ``operator_norm`` on card
    images, DAC off: the ``cuda`` backend gives the ``reference`` backend's
    iterations and eigenvalues (1e-5); Lanczos launches ``ec_matmul`` and
    the tier-2 kernel once per MVM (8 seed steps + one a step), LOBPCG once
    at entry and once a 6-column iteration, and ``operator_norm`` one
    ``ec_matmul`` and one ``ec_rmatmul`` a Lanczos step, seed steps
    included."""
    from repro_torch.solvers.eigen import _augmented
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 64, 64), encode_inputs=False,
                         denoise_method=method, lam=1e-2)
    tier2 = "thomas_solve" if method == "thomas" else "stencil_denoise"
    a = _separated_spd(200, 100)
    eng = {be: AnalogEngine(cfg, backend=be, device=cuda_device)
           for be in ("cuda", "reference")}
    A = eng["reference"].program(a, 4)
    views = {"reference": A, "cuda": _card_copy(A, eng["cuda"])}
    runs = {
        "lanczos": (lambda M: solvers.lanczos(M, tol=1e-3), 8),
        "lobpcg-largest": (lambda M: solvers.lobpcg(
            M, 2, which="largest", tol=1e-2, maxiter=100), 1),
        "lobpcg-smallest": (lambda M: solvers.lobpcg(
            M, 2, which="smallest", tol=1e-2, maxiter=100), 1)}
    for name, (solve, extra) in runs.items():
        want = solve(views["reference"])
        kernels.reset_launches()
        got = solve(views["cuda"])
        torch.cuda.synchronize()
        assert got.converged and want.converged, (name, got, want)
        assert got.iterations == want.iterations, name
        assert got.eigenvalues.device.type == "cuda"
        assert rel(got.eigenvalues, want.eigenvalues) <= 1e-5, name
        assert kernels.LAUNCHES["ec_matmul"] == extra + got.iterations
        assert kernels.LAUNCHES[tier2] == extra + got.iterations
    r = randn((300, 200), 101, "cpu") / 300 ** 0.5
    R = eng["reference"].program(r, 5)
    rviews = {"reference": R, "cuda": _card_copy(R, eng["cuda"])}
    norms = {be: solvers.operator_norm(M) for be, M in rviews.items()}
    assert abs(norms["cuda"] - norms["reference"]) <= 1e-5 * norms["reference"]
    assert norms["cuda"] == pytest.approx(
        float(torch.linalg.matrix_norm(r.double(), 2)), rel=2e-2)
    kernels.reset_launches()
    steps = solvers.lanczos(_augmented(solvers.as_operator(rviews["cuda"])),
                            tol=1e-3, maxiter=32)
    torch.cuda.synchronize()
    assert float(steps.eigenvalues[1]) == norms["cuda"]
    assert kernels.LAUNCHES["ec_matmul"] == 8 + steps.iterations
    assert kernels.LAUNCHES["ec_rmatmul"] == 8 + steps.iterations
    assert kernels.LAUNCHES[tier2] == 2 * (8 + steps.iterations)


def test_lanczos_omega_richardson_on_card(cuda_device):
    """``estimate_omega(method="lanczos")`` on a card image (epiram, EC on):
    16 Lanczos steps after 8 seed steps, one ``ec_matmul`` each, and
    Richardson at that omega converges through ``richardson_update``."""
    n = 512
    r = randn((n, n), 102, "cpu") / n
    a = r + r.T + 2.0 * torch.eye(n)
    x_true = randn((n,), 103, "cpu")
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 128, 128))
    A = AnalogEngine(cfg, backend="cuda", device=cuda_device).program(a, 6)
    kernels.reset_launches()
    omega = solvers.estimate_omega(A, method="lanczos")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ec_matmul"] == 8 + 16
    ev = torch.linalg.eigvalsh(a.double())
    assert omega == pytest.approx(
        float(2.0 / (1.05 * ev[-1] + ev[0])), rel=1e-2)
    kernels.reset_launches()
    res = solvers.richardson(A, (a @ x_true).to(cuda_device), omega=omega,
                             tol=1e-3, maxiter=50, backend="cuda")
    torch.cuda.synchronize()
    assert res.converged and rel(res.x.cpu(), x_true) <= 1e-3
    assert kernels.LAUNCHES["richardson_update"] == res.iterations
    assert kernels.LAUNCHES["ec_matmul"] == res.iterations


@pytest.mark.parametrize("method", ["neumann", "thomas"])
def test_admm_on_card_backends_agree(cuda_device, method):
    """ADMM on a card image of a random box QP (300 x 200, batch 2), DAC
    off: the ``cuda`` backend takes the ``reference`` backend's iterations,
    x and the split copy within 1e-5; every billed forward MVM is one
    ``ec_matmul`` launch and every billed transposed one one ``ec_rmatmul``
    launch, each with one tier-2 launch (with ``mu=None``: 16 power steps
    each way besides)."""
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 64, 64), encode_inputs=False,
                         denoise_method=method, lam=1e-2)
    tier2 = "thomas_solve" if method == "thomas" else "stencil_denoise"
    a, b, q, lo, hi, _ = solvers.random_box_qp(7, 300, 200, batch=2,
                                               device=cuda_device)
    eng = {be: AnalogEngine(cfg, backend=be, device=cuda_device)
           for be in ("cuda", "reference")}
    A = eng["reference"].program(a, 4)
    views = {"reference": A, "cuda": _card_copy(A, eng["cuda"])}
    for mu in (0.15, None):
        want = solvers.admm(views["reference"], b, q, lo=lo, hi=hi, mu=mu,
                            tol=1e-3, maxiter=500)
        kernels.reset_launches()
        got = solvers.admm(views["cuda"], b, q, lo=lo, hi=hi, mu=mu,
                           tol=1e-3, maxiter=500)
        torch.cuda.synchronize()
        assert got.converged and want.converged, (mu, got, want)
        assert got.iterations == want.iterations, mu
        assert got.x.device == views["cuda"].engine.device
        assert rel(got.x, want.x) <= 1e-5 and rel(got.dual, want.dual) <= 1e-5
        assert float(got.dual.min()) >= -1.0 and float(got.dual.max()) <= 1.0
        led = got.ledger
        assert led.mvms_single == led.mvms_single_t == (16 if mu is None
                                                        else 0)
        assert kernels.LAUNCHES["ec_matmul"] == led.mvms + led.mvms_single
        assert kernels.LAUNCHES["ec_rmatmul"] == \
            led.mvms_t + led.mvms_single_t
        assert kernels.LAUNCHES[tier2] == \
            led.mvms + led.mvms_single + led.mvms_t + led.mvms_single_t


@pytest.mark.parametrize("name", [s.name for s in solvers.registry()])
def test_registry_solver_on_card_ledger_contract(cuda_device, name):
    """Each registry solver on its seed-0 problem (n = 12) programmed on a
    ``cuda`` local engine (epiram, EC on, one 32^2 MCA): the total energy is
    the write plus the four (count x rate) terms, every billed MVM is one EC
    launch in its direction (LOBPCG: one launch for each 3k-column panel
    billed as three), the tier-2 kernel runs once per launch; on the dense
    problem on the card the recorded residual is honest and ``converged``
    mirrors it."""
    spec = {s.name: s for s in solvers.registry()}[name]
    p = spec.make_problem(0, 12, 1, device=cuda_device)
    A = AnalogEngine(contract_config(p["a"].shape[0]), backend="cuda",
                     device=cuda_device).program(p["a"], 0)
    run = RUN[spec.family]
    kernels.reset_launches()
    res = spec.solve(A, p, key=0, **run)
    torch.cuda.synchronize()
    led = res.ledger
    assert led.write_energy_j > 0
    assert led.total_energy_j == pytest.approx(
        led.write_energy_j
        + led.mvms * float(led.input_stats.energy_j)
        + led.mvms_single * float(led.input_stats_single.energy_j)
        + led.mvms_t * float(led.input_stats_t.energy_j)
        + led.mvms_single_t * float(led.input_stats_single_t.energy_j),
        rel=1e-12)
    fwd = 1 + res.iterations if name == "lobpcg" else \
        led.mvms + led.mvms_single
    assert kernels.LAUNCHES["ec_matmul"] == fwd
    assert kernels.LAUNCHES["ec_rmatmul"] == led.mvms_t + led.mvms_single_t
    assert kernels.LAUNCHES["stencil_denoise"] == \
        fwd + led.mvms_t + led.mvms_single_t
    if spec.needs_rmatvec:
        assert led.mvms_t + led.mvms_single_t >= 1
    digital = spec.solve(p["a"], p, key=0, **run)
    recorded = float(digital.final_residual)
    rec = spec.recompute(p, digital)
    assert rec <= max(spec.slack * recorded, spec.floor), (rec, recorded)
    if not spec.lagged_history:
        assert recorded <= max(spec.slack * rec, spec.floor), (rec, recorded)
    assert digital.converged == (recorded <= run["tol"])
    assert digital.ledger.total_energy_j == 0.0


def _mesh(shape, dev):
    from repro_torch.launch import make_mesh
    return make_mesh(shape, ("data", "model"), device=dev)


@pytest.mark.parametrize("method", ["neumann", "thomas"])
@pytest.mark.parametrize("transpose", [False, True])
def test_distributed_engine_on_card_matches_cpu_path(cuda_device, transpose,
                                                     method):
    """A dense handle over a 2 x 4 mesh on the card: one ``ec_matmul``
    (``ec_rmatmul``) launch per capacity block of every rank's window and
    one tier-2 launch per output segment (2 forward, 4 transposed), equal to
    the same handle on the CPU (plain versions) under the same injected
    draws, and, DAC off, to the ``reference`` backend on the card."""
    import dataclasses
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 64, 64), lam=1e-2,
                         denoise_method=method)
    a = randn((600, 520), 96, "cpu")     # windows 300 x 130: 3 x 2 blocks
    peta = randn((2, 4, 3, 2, 128, 128), 97, "cpu")
    handles = [AnalogEngine(cfg, execution="distributed", backend="cuda",
                            mesh=_mesh((2, 4), d)).program(
        a.to(d), 1, eta=peta.to(d)) for d in ("cpu", cuda_device)]
    C, G = handles
    u = randn((600 if transpose else 520, 3), 98, "cpu")
    dac = randn((2, 4, 3, 2, 128, 3), 99, "cpu")
    kernels.reset_launches()
    run = G.engine.rmvm if transpose else G.engine.mvm
    got = run(G, u.to(cuda_device), eta=dac.to(cuda_device))
    torch.cuda.synchronize()
    name = "ec_rmatmul" if transpose else "ec_matmul"
    tier2 = "thomas_solve" if method == "thomas" else "stencil_denoise"
    assert kernels.LAUNCHES[name] == 8 * 3 * 2
    assert kernels.LAUNCHES[tier2] == (4 if transpose else 2)
    want = (C.engine.rmvm if transpose else C.engine.mvm)(C, u, eta=dac)
    assert got.shape == want.shape and rel(got.cpu(), want) <= 1e-5
    exact = dataclasses.replace(cfg, encode_inputs=False)
    outs = []
    for be in ("cuda", "reference"):
        view = AnalogMatrix(
            engine=AnalogEngine(exact, execution="distributed", backend=be,
                                mesh=G.engine.mesh),
            shape=G.shape, base_key=1, write_stats=G.write_stats,
            mesh_sharded=True, at_ranks=G.at_ranks, da_ranks=G.da_ranks)
        outs.append((view.engine.rmvm if transpose else view.engine.mvm)(
            view, u.to(cuda_device)))
    assert rel(outs[0], outs[1]) <= 1e-5


def test_distributed_producer_on_card_equals_streamed(cuda_device):
    """With the port's own draws on the card: a 1 x 1 producer mesh is the
    streamed engine bit for bit in both directions, a 2 x 4 one equals it
    to 1e-5, and ``resident=False`` equals the resident 2 x 4 handle bit
    for bit at a call key other than the handle's."""
    from repro_torch.core.matrices import ImplicitBandedMatrix
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 128, 128))
    imp = ImplicitBandedMatrix(n=2048, cap_m=256, cap_n=256, seed=6,
                               device=cuda_device)
    x, y = randn((2048, 2), 100, cuda_device), randn((2048, 2), 101,
                                                      cuda_device)
    S = AnalogEngine(cfg, execution="streamed", backend="cuda",
                     device=cuda_device).program(imp.block, 3,
                                                 shape=(2048, 2048))
    handles = {}
    for label, shape, resident in (("1x1", (1, 1), True),
                                   ("2x4", (2, 4), True),
                                   ("2x4-nr", (2, 4), False)):
        eng = AnalogEngine(cfg, execution="distributed", backend="cuda",
                           mesh=_mesh(shape, cuda_device))
        handles[label] = eng.program(imp.block, 3, shape=(2048, 2048),
                                     resident=resident)

    def both(A, key):
        return A.engine.mvm(A, x, key=key), A.engine.rmvm(A, y, key=key)

    s = both(S, 3)
    one = both(handles["1x1"], 3)
    assert all(torch.equal(p, q) for p, q in zip(one, s))
    mesh = both(handles["2x4"], 3)
    assert all(rel(p, q) <= 1e-5 for p, q in zip(mesh, s))
    kernels.reset_launches()
    nr = both(handles["2x4-nr"], 9)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ec_matmul"] == kernels.LAUNCHES["ec_rmatmul"] \
        == 64
    assert all(torch.equal(p, q) for p, q in zip(nr, both(handles["2x4"], 9)))
    assert handles["2x4-nr"].image_nbytes == 0


def test_distributed_group_on_card_is_one_launch_a_rank(cuda_device):
    """A 3-member group over 2 x 4 on the card: one ``ec_group_matmul``
    launch per rank's window (every row strip of every member in it), one
    ``ec_group_rmatmul`` per rank's column block, one tier-2 launch per
    segment, equal to the same group on the CPU under the same draws, and
    member g equal to its solo distributed program bit for bit."""
    from repro_torch.core.prng import fold_in
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 64, 64), lam=1e-2)
    stack = randn((3, 600, 520), 102, "cpu")
    peta = randn((3, 2, 4, 3, 2, 128, 128), 103, "cpu")
    C, G = [AnalogEngine(cfg, execution="distributed", backend="cuda",
                         mesh=_mesh((2, 4), d)).program_group(
        stack.to(d), 2, eta=peta.to(d)) for d in ("cpu", cuda_device)]
    x = randn((3, 520, 4), 104, "cpu")
    y = randn((3, 600, 4), 105, "cpu")
    fe, be = randn((3, 2, 4, 3, 2, 128, 4), 106, "cpu"), \
        randn((3, 2, 4, 3, 2, 128, 4), 107, "cpu")
    kernels.reset_launches()
    got = G.engine.group_mvm(G, x.to(cuda_device), eta=fe.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ec_group_matmul"] == 8
    assert kernels.LAUNCHES["stencil_denoise"] == 2
    assert rel(got.cpu(), C.engine.group_mvm(C, x, eta=fe)) <= 1e-5
    kernels.reset_launches()
    got = G.engine.group_rmvm(G, y.to(cuda_device), eta=be.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ec_group_rmatmul"] == 8 * 2
    assert kernels.LAUNCHES["stencil_denoise"] == 4
    assert rel(got.cpu(), C.engine.group_rmvm(C, y, eta=be)) <= 1e-5
    solo = G.engine.program(stack[1].to(cuda_device), fold_in(2, 1),
                            eta=peta[1].to(cuda_device))
    assert all(torch.equal(p, q) for p, q in zip(
        G.member(1).at_ranks + G.member(1).da_ranks,
        solo.at_ranks + solo.da_ranks))


def test_aged_execute_on_card_matches_cpu_path(cuda_device):
    """The aging transform on the card: with the same injected fault draws
    the card's aged image equals the CPU's of the same stored image bit for
    bit, and an aged ``A @ x`` /
    ``A.T @ y`` (reference backend) the CPU path's to 1e-5; on the card's
    own draws the faulted set replays and only grows with age; the ``cuda``
    backend refuses an aged handle."""
    from repro_torch.reliability import aged_blocks, attach_age
    cfg = CrossbarConfig(device=get_device("ag-si"),
                         geom=MCAGeometry(2, 2, 64, 64))
    a = randn((256, 256), 110, "cpu")
    peta = randn((2, 2, 128, 128), 111, "cpu")
    draws = torch.rand((2, 2, 2, 128, 128),
                       generator=torch.Generator().manual_seed(112))
    n1 = int(40.0 / (cfg.device.fault_rate * 256 * 256))
    C, G = [AnalogEngine(cfg, device=d).program(a.to(d), 1, eta=peta.to(d))
            for d in ("cpu", cuda_device)]
    for h in (C, G):
        h.age = attach_age(h, draws=draws).advanced(n1).elapsed(600.0)
    aged = aged_blocks(G.at_blocks, G.age, cfg.device)
    assert torch.equal(aged.cpu(), aged_blocks(G.at_blocks.cpu(), C.age,
                                               cfg.device))
    u = randn((256, 3), 113, "cpu")
    dac = randn((2, 2, 128, 3), 114, "cpu")
    for run in ("mvm", "rmvm"):
        got = getattr(G.engine, run)(G, u.to(cuda_device),
                                     eta=dac.to(cuda_device))
        want = getattr(C.engine, run)(C, u, eta=dac)
        assert rel(got.cpu(), want) <= 1e-5
    assert float(G.age.mvms.min()) == n1 + 2
    G.age = attach_age(G).advanced(n1)

    def stuck(age):
        return (aged_blocks(G.at_blocks, age, cfg.device)
                - G.at_blocks).abs() > 1e-9

    s1 = stuck(G.age)
    assert torch.equal(s1, stuck(G.age)) and int(s1.sum()) >= 10
    s2 = stuck(G.age.advanced(4 * n1))
    assert bool(s2[s1].all()) and int(s2.sum()) > int(s1.sum())
    K = AnalogEngine(cfg, backend="cuda", device=cuda_device).program(
        a.to(cuda_device), 1)
    attach_age(K)
    with pytest.raises(ValueError, match="backend='reference'"):
        K @ u[:, 0].to(cuda_device)


def test_ft_solves_on_card_recover(cuda_device, tmp_path):
    """``ft_cg`` over a 2 x 4 mesh on the card (``cuda`` backend, the
    ``cg_update`` kernel inside): a column latched at the G_on rail in
    segment 1 is caught, rolled back and repaired, and the solve converges;
    ``ft_pdhg`` survives a NaN written into block (0, 0) with one
    restore."""
    from repro_torch.distributed import CheckpointManager
    from repro_torch.reliability import ft_cg, ft_pdhg
    n = 256
    r = randn((n, n), 115, cuda_device) / n
    a = r + r.T + 2.0 * torch.eye(n, device=cuda_device)
    b = a @ randn((n,), 116, cuda_device)
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 16, 16), k_iters=5)
    A = AnalogEngine(cfg, execution="distributed", backend="cuda",
                     mesh=_mesh((2, 4), cuda_device)).program(a, 3)
    saved = {}

    def inject(seg, h):
        if seg == 1 and not saved:
            saved["w"] = [w.clone() for w in h.at_ranks]
            rail = max(float(w.abs().max()) for w in h.at_ranks)
            for w, (_, c) in zip(h.at_ranks, h.engine._rank_grid.rc):
                if c == 0:
                    w[:, 5] = rail

    def repair(event, h):
        for w, s in zip(h.at_ranks, saved["w"]):
            w.copy_(s)

    kernels.reset_launches()
    res = ft_cg(A, b, tol=1e-4, segment=25, key=9, segment_hook=inject,
                on_fault=repair, backend="cuda",
                manager=CheckpointManager(str(tmp_path / "cg")))
    torch.cuda.synchronize()
    assert res.converged and res.restores >= 1
    assert res.fault_events[0].segment == 1
    assert kernels.LAUNCHES["cg_update"] > 0
    # 64 capacity blocks of 32^2, one ec_matmul each, every inner MVM.
    assert kernels.LAUNCHES["ec_matmul"] == 64 * res.ledger.mvms
    lp_a, lp_b, lp_c, _, _ = solvers.random_feasible_lp(0, 48, 64,
                                                        device=cuda_device)
    lcfg = CrossbarConfig(device=get_device("epiram"),
                          geom=MCAGeometry(2, 2, 16, 16), k_iters=5)
    L = AnalogEngine(lcfg, backend="cuda", device=cuda_device).program(
        lp_a, 4)
    state = {}

    def nan_hook(seg, h):
        if not state:
            state["at"] = h.at_pad
            h.at_pad = h.at_pad.clone()
            h.at_pad[0, 0] = float("nan")

    def nan_repair(event, h):
        h.at_pad = state["at"]

    res = ft_pdhg(L, lp_b, lp_c, tol=5e-2, maxiter=3000, segment=200,
                  key=12, segment_hook=nan_hook, on_fault=nan_repair,
                  manager=CheckpointManager(str(tmp_path / "lp")))
    assert res.converged and res.restores == 1
    assert [e.segment for e in res.fault_events] == [0]


# ------------------------------------------------------- the LM on the card
QWEN3_SHAPES = [(2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048),
                (2048, 152064)]


@pytest.mark.parametrize("shape", QWEN3_SHAPES,
                         ids=[f"{m}x{n}" for m, n in QWEN3_SHAPES])
def test_lm_dense_on_card_matches_plain_twin(cuda_device, shape):
    """The analog ``dense`` at qwen3-1.7b's five kernel shapes, 1 / 4 / 8 /
    64 rows (decode) and 256 / 1,024 (prefill's panels):
    ``ceil(rows / 8)`` ``ec_rmatmul`` launches and one
    ``stencil_denoise`` launch a call, within 1e-5 of its plain twin on the
    same x_tilde, bit for bit run to run (lam 1e-2, so tier-2 shows)."""
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models.common import Runtime, dense, dense_plain
    d_in, d_out = shape
    w = randn((d_in, d_out), 120, cuda_device) / d_in ** 0.5
    wt = w * (1 + 0.05 * randn((d_in, d_out), 121, cuda_device))
    p = {"w": w, "w_tilde": wt, "dw": (w - wt).to(torch.bfloat16)}
    rcfg = RRAMBackendConfig(enabled=True, lam=1e-2)
    for rows in (1, 4, 8, 64, 256, 1024):
        x = randn((rows, d_in), 122 + rows, cuda_device)
        kernels.reset_launches()
        got = dense(p, x, Runtime(rram=rcfg, key=3))
        torch.cuda.synchronize()
        assert dict(kernels.LAUNCHES) == {
            **{k: 0 for k in kernels.LAUNCHES},
            "ec_rmatmul": -(-rows // 8), "stencil_denoise": 1}
        assert rel(got, dense_plain(p, x, Runtime(rram=rcfg, key=3))) <= 1e-5
        assert torch.equal(got, dense(p, x, Runtime(rram=rcfg, key=3)))


def test_lm_decode_step_launch_count_on_card(cuda_device):
    """A reduced qwen3-1.7b programmed on the card: a decode step at 4
    rows launches 2 x 7 + 1 ``ec_rmatmul`` and as many ``stencil_denoise``
    and no other kernel; prefill at 4 x 6 = 24 rows three ``ec_rmatmul``
    a layer dense; its logits equal the CPU's on the same image to 1e-5
    with the DAC off."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Runtime
    from repro_torch.train.serve import Server
    cfg = get_arch("qwen3-1.7b").reduced()
    params = PM.materialize(tf.init_specs(cfg), 0, device=cuda_device)
    rt = Runtime(rram=RRAMBackendConfig(enabled=True, cell_rows=32,
                                        cell_cols=32))
    srv = Server(tf, cfg, params, rt=rt, max_len=16)
    tokens = torch.randint(0, cfg.vocab, (4, 6),
                           generator=torch.Generator().manual_seed(0))
    kernels.reset_launches()
    tok, caches = srv.prefill({"tokens": tokens.to(cuda_device)})
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ec_rmatmul"] == 2 * 7 * 3 + 1
    kernels.reset_launches()
    srv.decode_tokens(tok, caches, 1)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {
        **{k: 0 for k in kernels.LAUNCHES},
        "ec_rmatmul": 2 * 7 + 1, "stencil_denoise": 2 * 7 + 1}
    off = dataclasses.replace(rt.rram, encode_inputs=False)
    cpu_params = PM.tree_map(lambda t: t.cpu(), srv.params)
    want, _ = tf.prefill(cpu_params, {"tokens": tokens}, cfg,
                         Runtime(rram=off), 16)
    got, _ = tf.prefill(srv.params, {"tokens": tokens.to(cuda_device)}, cfg,
                        Runtime(rram=off), 16)
    assert rel(got.cpu(), want) <= 1e-5


# ------------------------------------ the attention-based families on the card
# Mixtral-8x7B's attention and head, whisper-tiny's kernels and head, and
# Llama-3.2-Vision-11B's MLP and head (its attention shapes are Mixtral's).
FAMILY_SHAPES = [(4096, 4096), (4096, 1024), (4096, 32000), (384, 384),
                 (384, 1536), (1536, 384), (384, 51968), (4096, 14336),
                 (14336, 4096), (4096, 128256)]


@pytest.mark.parametrize("shape", FAMILY_SHAPES,
                         ids=[f"{m}x{n}" for m, n in FAMILY_SHAPES])
def test_family_dense_on_card_matches_plain_twin(cuda_device, shape):
    """The analog ``dense`` at the new families' kernel shapes, on decode
    panels (1 / 4 / 8 rows), prompts (16 / 256) and whisper's 1,500 encoder
    frames: ``ceil(rows / 8)`` ``ec_rmatmul`` launches and one
    ``stencil_denoise`` a call, within 1e-5 of its plain twin, bit for bit
    run to run (lam 1e-2, dw in float32)."""
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models.common import Runtime, dense, dense_plain
    d_in, d_out = shape
    w = randn((d_in, d_out), 130, cuda_device) / d_in ** 0.5
    wt = w * (1 + 0.05 * randn((d_in, d_out), 131, cuda_device))
    p = {"w": w, "w_tilde": wt, "dw": w - wt}
    rcfg = RRAMBackendConfig(enabled=True, lam=1e-2, dw_dtype="float32")
    for rows in (1, 4, 8, 16, 256, 1500):
        x = randn((rows, d_in), 132 + rows, cuda_device)
        kernels.reset_launches()
        got = dense(p, x, Runtime(rram=rcfg, key=3))
        torch.cuda.synchronize()
        assert dict(kernels.LAUNCHES) == {
            **{k: 0 for k in kernels.LAUNCHES},
            "ec_rmatmul": -(-rows // 8), "stencil_denoise": 1}
        assert rel(got, dense_plain(p, x, Runtime(rram=rcfg, key=3))) <= 1e-5
        assert torch.equal(got, dense(p, x, Runtime(rram=rcfg, key=3)))


@pytest.mark.parametrize("cap", [8, 12, 80])
def test_expert_ec_on_card_matches_plain_twin(cuda_device, cap):
    """``moe.expert_mm`` on a programmed (E, D, F) stack and its (E, F, D)
    twin: one ``ec_group_rmatmul`` launch per 8 capacity slots and one
    ``stencil_denoise`` a call, within 1e-5 of ``expert_mm_plain`` with the
    same DAC draw, bit for bit run to run; DAC off within 1e-5 of the
    digital batched product."""
    import dataclasses
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import moe
    from repro_torch.models.common import Runtime
    e, d, f = 4, 512, 1536
    rcfg = RRAMBackendConfig(enabled=True, lam=1e-2, dw_dtype="float32")
    for shape, seed in (((e, d, f), 140), ((e, f, d), 150)):
        w = randn(shape, seed, cuda_device) / shape[1] ** 0.5
        wt = w * (1 + 0.05 * randn(shape, seed + 1, cuda_device))
        p = {"w": w, "w_tilde": wt, "dw": w - wt}
        x = randn((e, cap, shape[1]), seed + 2, cuda_device)
        kernels.reset_launches()
        got = moe.expert_mm(p, x, Runtime(rram=rcfg, key=4))
        torch.cuda.synchronize()
        assert dict(kernels.LAUNCHES) == {
            **{k: 0 for k in kernels.LAUNCHES},
            "ec_group_rmatmul": -(-cap // 8), "stencil_denoise": 1}
        assert got.shape == (e, cap, shape[2])
        assert rel(got, moe.expert_mm_plain(
            p, x, Runtime(rram=rcfg, key=4))) <= 1e-5
        assert torch.equal(got, moe.expert_mm(p, x,
                                              Runtime(rram=rcfg, key=4)))
        off = Runtime(rram=dataclasses.replace(rcfg, encode_inputs=False,
                                               lam=1e-12))
        assert rel(moe.expert_mm(p, x, off), torch.bmm(x, w)) <= 1e-5


@pytest.mark.parametrize("msz", [2, 4])
@pytest.mark.parametrize("layout", ["EDF", "EFD"])
def test_tp_shard_views_launch_without_a_copy(cuda_device, layout, msz):
    """Each rank's d_ff block of an (E, D, F) stack (its last dim: member
    stride D F, row stride F) and of an (E, F, D) stack (its rows: member
    stride F D) is a view that ``ec_group_rmatmul`` launches on as it is:
    the view's first and last element lie in the stack's storage, the
    call allocates no more than its output and workspace, one launch per
    8 columns of a member, within 1e-5 of the plain twin."""
    from repro_torch.distributed.sharding import NamedSharding, P, shard
    from repro_torch.launch import make_mesh
    # Images large enough that a copy of the two blocks would outgrow the
    # launches' workspaces (~6.5 MB a launch on an H100).
    e, d, f, cap = 4, 1024, 4096, 12
    shape = (e, d, f) if layout == "EDF" else (e, f, d)
    spec = P(None, None, "model") if layout == "EDF" else P(None, "model")
    at, da = randn(shape, 160, cuda_device), randn(shape, 161, cuda_device)
    grid = make_mesh((1, msz), ("data", "model"), cuda_device)
    lo = at.data_ptr()
    hi = lo + at.numel() * at.element_size()
    for r, (av, dv) in enumerate(zip(shard(at, NamedSharding(grid, spec)),
                                     shard(da, NamedSharding(grid, spec)))):
        last = av.data_ptr() + sum((n - 1) * st for n, st in
                                   zip(av.shape, av.stride())) * 4
        assert lo <= av.data_ptr() and last < hi and not av.is_contiguous()
        rows = av.shape[1]
        y = randn((rows, e * cap), 162 + r, cuda_device)
        yt = randn((rows, e * cap), 163 + r, cuda_device)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        got = kernels.ec_group_rmatmul(av, dv, y, yt)
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - before
        # The output and the launches' workspaces (the next launch's is
        # allocated before the last one's is released); a copy of the two
        # images would add 2 x the view's bytes.
        ws = sum(kernels.rmatmul_layout(av, dv, min(8, cap - c0))
                 .workspace_floats for c0 in range(0, cap, 8)) * 4
        assert kernels.LAUNCHES["ec_group_rmatmul"] == -(-cap // 8)
        assert grew <= got.numel() * 4 + ws + 2048 < 2 * av.numel() * 4, \
            (grew, ws)
        assert got.shape == (av.shape[2], e * cap)
        assert rel(got, kernels.ec_group_rmatmul_plain(av, dv, y, yt)) <= 1e-5


def test_moe_tensor_parallel_on_card_matches_plain(cuda_device, monkeypatch):
    """``moe_apply`` on a 2 x 4 card mesh over a programmed tree: each
    rank's three ``expert_mm`` run the kernels on views of its d_ff block
    (3 ceil(cap / 8) ec_group_rmatmul + 3 stencil_denoise a rank, nothing
    else), within 1e-5 of the same call through the plain twins; a 1 x 1
    mesh equals the local call bit for bit."""
    import dataclasses
    import math
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.launch import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import Runtime
    cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(), d_model=256,
                              d_ff=1024)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    tree = {}
    for i, (name, shape) in enumerate((("router", (d, e)), ("wd", (e, f, d)),
                                       ("wg", (e, d, f)), ("wu", (e, d, f)))):
        w = randn(shape, 170 + i, cuda_device) / math.sqrt(shape[-2])
        wt = w * (1 + 0.05 * randn(shape, 180 + i, cuda_device))
        tree[name] = {"w": w, "w_tilde": wt, "dw": w - wt}
    rcfg = RRAMBackendConfig(enabled=True, lam=1e-2, dw_dtype="float32")
    x = randn((2, 24, d), 190, cuda_device)
    grid = make_mesh((2, 4), ("data", "model"), cuda_device)
    kernels.reset_launches()
    got, aux = moe.moe_apply(tree, x, cfg, Runtime(rram=rcfg, key=6,
                                                   mesh=grid))
    torch.cuda.synchronize()
    cap = moe._capacity(24, cfg)
    assert dict(kernels.LAUNCHES) == {
        **{k: 0 for k in kernels.LAUNCHES},
        "ec_group_rmatmul": 8 * 3 * -(-cap // 8), "stencil_denoise": 8 * 3}
    one = make_mesh((1, 1), ("data", "model"), cuda_device)
    assert torch.equal(
        moe.moe_apply(tree, x, cfg, Runtime(rram=rcfg, key=6, mesh=one))[0],
        moe.moe_apply(tree, x, cfg, Runtime(rram=rcfg, key=6))[0])
    monkeypatch.setattr(moe, "expert_mm", moe.expert_mm_plain)
    want, want_aux = moe.moe_apply(tree, x, cfg, Runtime(rram=rcfg, key=6,
                                                         mesh=grid))
    assert rel(got, want) <= 1e-5 and torch.equal(aux, want_aux)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "whisper-tiny",
                                  "llama-3.2-vision-11b"])
def test_family_decode_step_launch_count_on_card(cuda_device, arch):
    """A reduced model of each new family programmed on the card (cells of
    32^2): a decode step launches one ``ec_rmatmul`` per 8 rows of every
    analog dense (the MoE experts' and llama-vision's self layers' 4-D
    stacks are digital; whisper's cross-attention projects its 24 encoder
    frames, llama-vision's its 16 patches, again) and one
    ``stencil_denoise`` each, nothing else; the prefill's logits with the
    DAC off equal the CPU's on the same image to 1e-5."""
    import dataclasses
    from repro_torch.configs import get_arch, model_module
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import params as PM
    from repro_torch.models.common import Runtime
    from repro_torch.train.serve import Server
    cfg = get_arch(arch).reduced()
    mod = model_module(cfg)
    params = PM.materialize(mod.init_specs(cfg), 0, device=cuda_device)
    rt = Runtime(rram=RRAMBackendConfig(enabled=True, cell_rows=32,
                                        cell_cols=32))
    srv = Server(mod, cfg, params, rt=rt, max_len=16)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 6), generator=gen)}
    if cfg.family == "whisper":
        batch["frames"] = torch.randn(4, 24, cfg.d_model, generator=gen)
        # 2 layers x (self 4 + cross wq, wk, wv on 4 x 24 rows, wo + mlp 2)
        per_step = 2 * (4 + 1 + 2 * 12 + 1 + 2) + 1
    elif cfg.family == "llama_vision":
        batch["patches"] = torch.randn(4, cfg.n_patches, cfg.d_model,
                                       generator=gen)
        per_step = 1 + 2 * 8 + 1 + 3 + 1      # one cross layer + head
    else:
        per_step = 2 * 4 + 1                  # attention 4 a layer + head
    stencils = {"whisper-tiny": 2 * 10 + 1, "llama-3.2-vision-11b": 8,
                "mixtral-8x7b": 9}[arch]
    on_card = {k: v.to(cuda_device) for k, v in batch.items()}
    tok, caches = srv.prefill(on_card)
    kernels.reset_launches()
    srv.decode_tokens(tok, caches, 1)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {
        **{k: 0 for k in kernels.LAUNCHES},
        "ec_rmatmul": per_step, "stencil_denoise": stencils}
    off = dataclasses.replace(rt.rram, encode_inputs=False)
    cpu_params = PM.tree_map(lambda t: t.cpu(), srv.params)
    want, _ = mod.prefill(cpu_params, batch, cfg, Runtime(rram=off), 16)
    got, _ = mod.prefill(srv.params, on_card, cfg, Runtime(rram=off), 16)
    assert rel(got.cpu(), want) <= 1e-5


# -------------------------------------------- the recurrent families on the card
# rwkv6-1.6b's and zamba2-1.2b's kernel shapes that no test above covers
# (their 2,048^2 is qwen3-1.7b's).
RECURRENT_SHAPES = [(2048, 64), (2048, 7168), (7168, 2048), (2048, 65536),
                    (4096, 2048), (2048, 4096), (2048, 32000)]


@pytest.mark.parametrize("shape", RECURRENT_SHAPES,
                         ids=[f"{m}x{n}" for m, n in RECURRENT_SHAPES])
def test_recurrent_dense_on_card_matches_plain_twin(cuda_device, shape):
    """The analog ``dense`` at the recurrent families' kernel shapes, on
    decode panels (1 / 4 / 8 rows) and prompts (256 / 1,024): ``ceil(rows
    / 8)`` ``ec_rmatmul`` launches and one ``stencil_denoise`` a call,
    within 1e-5 of its plain twin, bit for bit run to run (lam 1e-2, dw in
    float32)."""
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models.common import Runtime, dense, dense_plain
    d_in, d_out = shape
    w = randn((d_in, d_out), 160, cuda_device) / d_in ** 0.5
    wt = w * (1 + 0.05 * randn((d_in, d_out), 161, cuda_device))
    p = {"w": w, "w_tilde": wt, "dw": w - wt}
    rcfg = RRAMBackendConfig(enabled=True, lam=1e-2, dw_dtype="float32")
    for rows in (1, 4, 8, 256, 1024):
        x = randn((rows, d_in), 162 + rows, cuda_device)
        kernels.reset_launches()
        got = dense(p, x, Runtime(rram=rcfg, key=3))
        torch.cuda.synchronize()
        assert dict(kernels.LAUNCHES) == {
            **{k: 0 for k in kernels.LAUNCHES},
            "ec_rmatmul": -(-rows // 8), "stencil_denoise": 1}
        assert rel(got, dense_plain(p, x, Runtime(rram=rcfg, key=3))) <= 1e-5
        assert torch.equal(got, dense(p, x, Runtime(rram=rcfg, key=3)))


@pytest.mark.parametrize("fn", ["wkv", "ssd"])
def test_recurrences_on_card_match_cpu(cuda_device, fn):
    """``chunked_wkv`` / ``chunked_ssd`` (two chunks from a given state)
    and their single-token steps on the card against the same calls on the
    CPU: outputs and states within 1e-5."""
    from repro_torch.models import linear_attention as la
    b, t, h, d = 2, 64, 4, 32
    q, k, v = (randn((b, t, h, d), 170 + i, "cpu") for i in range(3))
    lshape = (b, t, h, d) if fn == "wkv" else (b, t, h)
    logd = -torch.exp(randn(lshape, 173, "cpu"))
    u = randn((h, d), 174, "cpu")
    s0 = randn((b, h, d, d), 175, "cpu")

    def run(dev):
        a = [x.to(dev) for x in (q, k, v, logd, u, s0)]
        if fn == "wkv":
            return (*la.chunked_wkv(*a[:5], state0=a[5]),
                    *la.wkv_decode_step(*(x[:, 0] for x in a[:4]), a[4],
                                        a[5]))
        return (*la.chunked_ssd(*a[:4], state0=a[5]),
                *la.ssd_decode_step(*(x[:, 0] for x in a[:4]), a[5]))

    for got, want in zip(run(cuda_device), run("cpu")):
        assert got.device.type == "cuda" and rel(got.cpu(), want) <= 1e-5


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_recurrent_decode_step_launch_count_on_card(cuda_device, arch):
    """A reduced model of each recurrent family programmed on the card
    (cells of 32^2; zamba2 at 5 layers: two groups and an analog tail): a
    decode step at 4 rows launches one ``ec_rmatmul`` and one
    ``stencil_denoise`` per analog dense (rwkv6 9 a layer + the head;
    zamba2 6 a shared-block invocation + 6 a tail block + the head; its
    grouped mamba blocks are digital), nothing else; a 4 x 64-token
    prefill (two chunks) 32 ``ec_rmatmul`` a dense and one for the head's
    last tokens; its logits and caches with the DAC off equal the CPU's on
    the same image to 1e-5."""
    import dataclasses
    from repro_torch.configs import get_arch, model_module
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import params as PM
    from repro_torch.models.common import Runtime
    from repro_torch.train.serve import Server
    cfg = get_arch(arch).reduced()
    if cfg.family == "zamba2":
        cfg = dataclasses.replace(cfg, n_layers=5)
    mod = model_module(cfg)
    params = PM.materialize(mod.init_specs(cfg), 0, device=cuda_device)
    rt = Runtime(rram=RRAMBackendConfig(enabled=True, cell_rows=32,
                                        cell_cols=32))
    srv = Server(mod, cfg, params, rt=rt, max_len=72)
    denses = 9 * 2 + 1 if cfg.family == "rwkv6" else 6 * 2 + 6 + 1
    tokens = torch.randint(0, cfg.vocab, (4, 64),
                           generator=torch.Generator().manual_seed(0))
    kernels.reset_launches()
    tok, caches = srv.prefill({"tokens": tokens.to(cuda_device)})
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ec_rmatmul"] == (denses - 1) * 32 + 1
    kernels.reset_launches()
    srv.decode_tokens(tok, caches, 1)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {
        **{k: 0 for k in kernels.LAUNCHES},
        "ec_rmatmul": denses, "stencil_denoise": denses}
    off = dataclasses.replace(rt.rram, encode_inputs=False)
    cpu_params = PM.tree_map(lambda t: t.cpu(), srv.params)
    want, want_c = mod.prefill(cpu_params, {"tokens": tokens}, cfg,
                               Runtime(rram=off), 72)
    got, got_c = mod.prefill(srv.params, {"tokens": tokens.to(cuda_device)},
                             cfg, Runtime(rram=off), 72)
    assert rel(got.cpu(), want) <= 1e-5
    for (path, g), (_, w) in zip(PM.tree_paths(got_c),
                                 PM.tree_paths(want_c)):
        if g.dtype.is_floating_point:
            assert rel(g.cpu(), w) <= 1e-5, path


# --------------------------------------------------- training on the card
def _dense_grads(fn, p, x, cot, rt):
    """Gradients of ``x``, ``w_tilde`` and ``dw`` through ``fn``."""
    live = [x.clone().requires_grad_(), p["w_tilde"].clone().requires_grad_(),
            p["dw"].clone().requires_grad_()]
    out = fn({"w": p["w"], "w_tilde": live[1], "dw": live[2]}, live[0], rt)
    return torch.autograd.grad(out, live, cot)


@pytest.mark.parametrize("shape", QWEN3_SHAPES,
                         ids=[f"{m}x{n}" for m, n in QWEN3_SHAPES])
def test_lm_dense_gradient_on_card_matches_plain_autograd(cuda_device,
                                                          shape):
    """The analog ``dense``'s autograd function (its backward: one more
    ``stencil_denoise`` and four matmuls) at qwen3-1.7b's kernel shapes, 8
    and 64 rows: x, w_tilde and dw within 1e-5 of ``dense_plain``'s plain
    autograd under the same DAC key, bit for bit run to run;
    ``ceil(rows / 8)`` ``ec_rmatmul`` + 2 ``stencil_denoise`` launches."""
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models.common import Runtime, dense, dense_plain
    d_in, d_out = shape
    w = randn((d_in, d_out), 160, cuda_device) / d_in ** 0.5
    wt = w * (1 + 0.05 * randn((d_in, d_out), 161, cuda_device))
    p = {"w": w, "w_tilde": wt, "dw": w - wt}
    rcfg = RRAMBackendConfig(enabled=True, lam=1e-2, dw_dtype="float32")
    for rows in (8, 64):
        x = randn((rows, d_in), 162 + rows, cuda_device)
        cot = randn((rows, d_out), 163 + rows, cuda_device)
        kernels.reset_launches()
        got = _dense_grads(dense, p, x, cot, Runtime(rram=rcfg, key=3))
        torch.cuda.synchronize()
        assert dict(kernels.LAUNCHES) == {
            **{k: 0 for k in kernels.LAUNCHES},
            "ec_rmatmul": -(-rows // 8), "stencil_denoise": 2}
        want = _dense_grads(dense_plain, p, x, cot, Runtime(rram=rcfg, key=3))
        again = _dense_grads(dense, p, x, cot, Runtime(rram=rcfg, key=3))
        for a, b, c in zip(got, want, again):
            assert rel(a, b) <= 1e-5 and torch.equal(a, c)


@pytest.mark.parametrize("cap", [8, 12])
def test_expert_mm_gradient_on_card_matches_plain_autograd(cuda_device, cap):
    """``moe.expert_mm``'s stacked backward on a programmed (E, D, F) stack:
    x, w_tilde and dw within 1e-5 of ``expert_mm_plain``'s autograd, one
    ``ec_group_rmatmul`` per 8 slots + 2 ``stencil_denoise`` launches."""
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import moe
    from repro_torch.models.common import Runtime
    e, d, f = 4, 512, 1536
    w = randn((e, d, f), 170, cuda_device) / d ** 0.5
    wt = w * (1 + 0.05 * randn((e, d, f), 171, cuda_device))
    p = {"w": w, "w_tilde": wt, "dw": w - wt}
    rcfg = RRAMBackendConfig(enabled=True, lam=1e-2, dw_dtype="float32")
    x = randn((e, cap, d), 172, cuda_device)
    cot = randn((e, cap, f), 173, cuda_device)
    kernels.reset_launches()
    got = _dense_grads(moe.expert_mm, p, x, cot, Runtime(rram=rcfg, key=4))
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {
        **{k: 0 for k in kernels.LAUNCHES},
        "ec_group_rmatmul": -(-cap // 8), "stencil_denoise": 2}
    want = _dense_grads(moe.expert_mm_plain, p, x, cot,
                        Runtime(rram=rcfg, key=4))
    for a, b in zip(got, want):
        assert rel(a, b) <= 1e-5


def test_train_step_on_card_matches_cpu(cuda_device):
    """One train step of reduced qwen3-1.7b (microbatch 2, remat block) on
    the card and on the CPU from the same parameters and batch: the loss
    and grad norm within 1e-5, m (0.1 x the clipped gradient) within 1e-4
    a leaf, and the parameters' change within 1e-3 a leaf (Adam's first
    step turns a near-zero gradient into +-lr, as in
    ``test_torch_train.py``)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.train import adamw_init, make_train_step
    cfg = get_arch("qwen3-1.7b").reduced()
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10, microbatch=2)
    params = PM.materialize(tf.init_specs(cfg), 0, device=cuda_device)
    host = PM.tree_map(lambda t: t.cpu(), params)
    before = PM.tree_map(lambda t: t.clone(), host)
    batch = synthetic_batch(cfg, 4, 16, step=0)
    out = {}
    for name, prm in (("card", params), ("cpu", host)):
        prm, state, m = make_train_step(tf, cfg, tcfg)(prm, adamw_init(prm),
                                                       batch)
        out[name] = (prm, state, m)
    (p_d, s_d, m_d), (p_h, s_h, m_h) = out["card"], out["cpu"]
    for key in ("loss", "grad_norm"):
        assert abs(float(m_d[key]) - float(m_h[key])) <= 1e-5 * abs(
            float(m_h[key]))
    for (path, a), (_, b) in zip(PM.tree_paths(s_d.m), PM.tree_paths(s_h.m)):
        assert rel(a.cpu(), b) <= 1e-4, path
    for (path, a), (_, b), (_, c) in zip(PM.tree_paths(p_d),
                                         PM.tree_paths(p_h),
                                         PM.tree_paths(before)):
        assert rel(a.cpu() - c, b - c) <= 1e-3, path


def test_programmed_model_backward_on_card(cuda_device):
    """A reduced qwen3-1.7b programmed on the card, its loss's backward
    with remat block: 15 analog denses a pass (14 in the layers, which
    the recompute runs again) -> (15 + 14) x ceil(24 / 8) ``ec_rmatmul``
    and 15 + 14 + 15 ``stencil_denoise`` launches, nothing else; with the
    DAC off the gradients equal the CPU's on the same image to 1e-4."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Runtime
    from repro_torch.models.rram import program_rram
    from repro_torch.train.train_loop import loss_and_grads
    cfg = get_arch("qwen3-1.7b").reduced()
    params = PM.materialize(tf.init_specs(cfg), 0, device=cuda_device)
    rcfg = RRAMBackendConfig(enabled=True, cell_rows=32, cell_cols=32,
                             dw_dtype="float32")
    prog, _ = program_rram(params, rcfg, 5)
    batch = synthetic_batch(cfg, 4, 6, step=0)

    def grads(prm, rram, dev):
        return loss_and_grads(tf, prm, {k: torch.from_numpy(v).to(dev)
                                        for k, v in batch.items()}, cfg,
                              Runtime(rram=rram, key=7, remat="block"))[1]

    kernels.reset_launches()
    got = grads(prog, rcfg, cuda_device)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {
        **{k: 0 for k in kernels.LAUNCHES},
        "ec_rmatmul": (15 + 14) * 3, "stencil_denoise": 15 + 14 + 15}
    assert all(bool(torch.isfinite(g).all()) for g in got if g is not None)
    off = dataclasses.replace(rcfg, encode_inputs=False)
    cpu_prog = PM.tree_map(lambda t: t.cpu(), prog)
    for (path, _), a, b in zip(PM.tree_paths(prog),
                               grads(prog, off, cuda_device),
                               grads(cpu_prog, off, "cpu")):
        assert (a is None) == (b is None), path
        if a is not None:
            assert rel(a.cpu(), b) <= 1e-4, path


def _serving_cfg(rram, run_model):
    """Two reduced rwkv6 tenants, 8 requests, a cache below two images (the
    trace evicts and reprograms)."""
    from repro_torch.serving import (BatchingConfig, ServingConfig,
                                     TenantSpec, TrafficConfig)
    return ServingConfig(
        tenants=(TenantSpec("acme", "rwkv6-1.6b"),
                 TenantSpec("initech", "rwkv6-1.6b")),
        traffic=TrafficConfig(n_requests=8, rate_rps=6.0, zipf_s=1.0,
                              prompt_lens=(4, 8), prompt_mix=(0.6, 0.4),
                              decode_lens=(3, 5), decode_mix=(0.6, 0.4),
                              seed=2),
        batching=BatchingConfig(max_batch=2, prompt_buckets=(4, 8),
                                decode_buckets=(4, 8), batch_buckets=(1, 2)),
        rram=rram, cache_capacity_bytes=1_000_000, policy="write_cost",
        seed=0, max_len=32, run_model=run_model)


@pytest.mark.parametrize("analog", [True, False])
def test_simulate_on_the_card_equals_the_cpu(cuda_device, analog):
    """``simulate`` serving every batch on the card (``run_model=True``)
    gives the records, summary and cache stats of the CPU's run without
    the model; the analog run launches the EC kernels and nothing else,
    the digital run none.  The equality covers the simulator's bookkeeping
    (host arithmetic on shapes), not the tokens the card computes."""
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.serving import simulate
    rram = RRAMBackendConfig(enabled=True) if analog else None
    kernels.reset_launches()
    card = simulate(_serving_cfg(rram, True))
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    host = simulate(_serving_cfg(rram, False), device="cpu")
    assert card.records == host.records and card.summary == host.summary
    assert card.cache_stats == host.cache_stats
    used = {k for k, v in counts.items() if v}
    assert used == ({"ec_rmatmul", "stencil_denoise"} if analog else set())
    if analog:
        assert card.cache_stats["reprograms"] >= 1


def test_image_cache_eviction_frees_the_image_on_the_card(cuda_device):
    """A reduced programmed Server evicted from an ImageCache gives back
    its ``analog_image_bytes`` of device memory once the caller drops it;
    the digital weights it shared stay."""
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Runtime
    from repro_torch.models.rram import analog_image_bytes, strip_rram
    from repro_torch.serving import ImageCache
    from repro_torch.train.serve import Server
    cfg = get_arch("qwen3-1.7b").reduced()
    params = PM.materialize(tf.init_specs(cfg), 0, device=cuda_device)
    rram = RRAMBackendConfig(enabled=True, cell_rows=32, cell_cols=32,
                             dw_dtype="float32")

    def build(key):
        def run():
            srv = Server(tf, cfg, strip_rram(params), rt=Runtime(rram=rram),
                         max_len=16, key=key)
            return srv, analog_image_bytes(srv.params), srv.write_stats
        return run

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    a = build(1)()[0]
    image = analog_image_bytes(a.params)
    del a
    gc.collect()
    assert torch.cuda.memory_allocated() == base
    cache = ImageCache(int(1.5 * image), "lru")
    first, _ = cache.get("a", build(1), 0.0)
    # The allocator rounds each block up to 512 bytes.
    assert abs(torch.cuda.memory_allocated() - base - image) <= 0.01 * image
    del first
    second, out = cache.get("b", build(2), 1.0)
    assert out.evicted == ("a",)
    gc.collect()
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated() - base - image) <= 0.01 * image
    del second, cache
    gc.collect()
    assert torch.cuda.memory_allocated() == base


@pytest.mark.parametrize("solver", ["cg", "lsqr", "lsmr", "pdhg"])
def test_solver_cores_on_card_equal_their_solvers(cuda_device, solver):
    """Each core (``cg_pipeline`` with the ``cg_update`` kernel,
    ``lsqr_pipeline``, ``lsmr_pipeline``, ``pdhg_pipeline`` with the power
    steps) on a programmed image on the card is its public solver bit for
    bit: x, the history, the iterations and the MVMs; and its launches
    are one EC launch and one stencil an MVM (CG: one cg_update an
    iteration)."""
    dev = cuda_device
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 64, 64))
    if solver == "cg":
        r = randn((256, 256), 110, dev) / 256
        a = r + r.T + 2 * torch.eye(256, device=dev)
        b = randn((256,), 111, dev)
    elif solver == "pdhg":
        a, b, c, _, _ = solvers.random_feasible_lp(3, 96, 200, device=dev)
    else:
        a = randn((300, 160), 112, dev) / 300 ** 0.5
        b = randn((300,), 113, dev)
    A = AnalogEngine(cfg, backend="cuda", device=dev).program(a, 5)
    op = solvers.as_operator(A)
    zeros = torch.zeros(a.shape[1], 1, device=dev)
    if solver == "cg":
        res = solvers.cg(A, b, tol=1e-4, maxiter=50, key=3, backend="cuda")
        core = solvers.cg_pipeline(op, tol=1e-4, maxiter=50, backend="cuda")
        args = (b[:, None], zeros, 3)
    elif solver == "pdhg":
        res = solvers.pdhg(A, b, c, tol=1e-3, maxiter=3000, key=3,
                           power_iters=8)
        core = solvers.pdhg_pipeline(op, tol=1e-3, maxiter=3000,
                                     power_iters=8)
        args = (b[:, None], c[:, None], zeros,
                torch.zeros(a.shape[0], 1, device=dev), 3)
    else:
        res = getattr(solvers, solver)(A, b, tol=1e-4, maxiter=100, key=3)
        core = getattr(solvers, f"{solver}_pipeline")(op, tol=1e-4,
                                                      maxiter=100)
        args = (b[:, None], zeros, 3)
    kernels.reset_launches()
    out = core(*args)
    torch.cuda.synchronize()
    x, (hist, k, mvms) = out[0], (out[1:4] if len(out) == 5 else out[2:5])
    assert torch.equal(x[:, 0], res.x) and k == res.iterations > 1
    assert mvms == res.ledger.mvms == 1 + k
    assert torch.equal(hist[:k, 0], res.residuals[:k])
    assert bool(torch.isnan(hist[k:]).all())
    fwd = mvms + (out[5] if solver == "pdhg" else 0)
    back = 0 if solver == "cg" else fwd
    assert kernels.LAUNCHES["ec_matmul"] == fwd
    assert kernels.LAUNCHES["ec_rmatmul"] == back
    assert kernels.LAUNCHES["stencil_denoise"] == fwd + back
    assert kernels.LAUNCHES["cg_update"] == (k if solver == "cg" else 0)
    if solver == "pdhg":
        assert torch.equal(out[1][:, 0], res.dual) and out[5] == 8


def test_analysis_memory_on_card(cuda_device):
    """``max_aval_elements`` and ``peak_bytes`` on a small virtual handle
    (a 1 x 1 ``resident=False`` 1,024^2 banded producer, 64^2 capacity
    blocks) on the card: the largest tensor one capacity block, under
    n^2/8; the peak over the call above zero and at most 12 blocks; and
    ``peak_bytes`` refuses a call on the CPU."""
    from repro_torch import analysis
    from repro_torch.core.matrices import ImplicitBandedMatrix
    dev = cuda_device
    n, cap = 1024, 64
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 32, 32), k_iters=5, ec=True)
    imp = ImplicitBandedMatrix(n=n, cap_m=cap, cap_n=cap, seed=2,
                               device=dev)
    eng = AnalogEngine(cfg, execution="distributed", backend="cuda",
                       mesh=_mesh((1, 1), dev))
    A = eng.program(imp.block, 7, shape=(n, n), resident=False)
    x = randn((n,), 114, dev)
    for transpose in (False, True):
        fn = eng.mvm_fn(A, transpose=transpose)
        elems = analysis.max_aval_elements(fn, x, 7)
        peak = analysis.peak_bytes(fn, x, 7)
        assert cap * cap <= elems < n * n // 8
        assert elems <= 4 * cap * cap
        assert 0 < peak <= 12 * 4 * cap * cap
        assert torch.equal(fn(x, 7), fn(x, 7))
    with pytest.raises(ValueError, match="CUDA"):
        analysis.peak_bytes(lambda v: v * 2, x.cpu())


# The kernels each -cuda registry entry (and the analog decode) launches,
# from its shapes: one EC kernel + one stencil a local MVM or group call,
# one EC kernel a 64^2 block (16) + one stencil a streamed MVM, one
# ec_matmul a block of each of the chain's 8 members (2 x 2 blocks; its
# tier-2 is plain), and for the decode one ec_rmatmul + one stencil an
# analog dense (19 a step, 8 steps).
REGISTRY_LAUNCHES = {
    "local-forward-cuda": {"ec_matmul": 1, "stencil_denoise": 1},
    "local-rmatvec-cuda": {"ec_rmatmul": 1, "stencil_denoise": 1},
    "streamed-forward-cuda": {"ec_matmul": 16, "stencil_denoise": 1},
    "streamed-rmatvec-cuda": {"ec_rmatmul": 16, "stencil_denoise": 1},
    "group-forward-cuda": {"ec_group_matmul": 1, "stencil_denoise": 1},
    "group-rmatvec-cuda": {"ec_group_rmatmul": 1, "stencil_denoise": 1},
    "group-chain-wholemodel-cuda": {"ec_matmul": 32},
    "serving-decode-fused-rwkv6": {"ec_rmatmul": 152,
                                   "stencil_denoise": 152},
}


def test_invariant_registry_launches_on_card(cuda_device):
    """The registry's entries that reach a kernel, on the card at the
    paper's scale (these entries are the same at both scales): no
    violation, each kernel's launches as their shapes give them and as the
    ``cuda`` section of INVARIANTS_torch.json holds them; every other
    small entry launches nothing."""
    import json
    from pathlib import Path
    from repro_torch.analysis import pipelines as P
    want = json.loads((Path(__file__).resolve().parents[1]
                       / "INVARIANTS_torch.json").read_text())["cuda"]
    for spec in P.registered_pipelines(device=cuda_device, scale="paper"):
        if "virtual65536" in spec.name or spec.direction == "solve":
            continue
        reports = P.verify_pipeline(spec)
        row = P.manifest_record(spec, reports)
        assert row["violations"] == [], (spec.name, row["violations"])
        assert row["launches"] == REGISTRY_LAUNCHES.get(spec.name, {}), \
            spec.name
        assert row == want[spec.name], spec.name


def test_invariant_audit_peak_on_small_virtual(cuda_device):
    """``run_all(peak=True)`` on a 512^2 ``resident=False`` virtual MVM on
    the card (64 blocks of 64^2, the registry's CPU scale): the peak over
    the start in AvalBound's summary, above zero and within 12 capacity
    blocks; the largest tensor one block; 64 producer calls; no launch
    (the reference backend)."""
    from repro_torch.analysis import pipelines as P
    spec = {s.name: s for s in P.registered_pipelines(
        device=cuda_device, scale="cpu")}[
            "distributed-virtual65536-forward-2x4"]
    reports = P.verify_pipeline(spec, peak=True)
    assert all(r.ok for r in reports.values())
    ab = reports["AvalBound"].summary
    assert ab["max_elements"] == 64 * 64
    assert 0 < ab["peak_bytes"] <= 12 * 4 * 64 * 64
    dc = reports["DispatchCount"].summary
    assert (dc["producer_calls"], dc["launches"]) == (64, {})


# --------------------------------------------------------------------------
# the declared costs and the roofline on the card
# --------------------------------------------------------------------------

def test_roofline_hw_is_this_card(cuda_device):
    """The roofline's ``HW`` names this card and its memory."""
    from repro_torch.analysis import HW
    assert HW["card"] == torch.cuda.get_device_name(0)
    assert HW["hbm_bytes"] == \
        torch.cuda.get_device_properties(cuda_device).total_memory


@pytest.mark.parametrize("name", ["ec_matmul", "ec_rmatmul",
                                  "ec_group_matmul", "ec_group_rmatmul",
                                  "stencil_denoise", "thomas_solve",
                                  "cg_update", "richardson_update",
                                  "encode_matmul", "encode_matmul_rng"])
def test_declared_cost_same_on_card_and_cpu(cuda_device, name):
    """Each kernel function, as its wrapper (the CUDA kernel) and as its
    plain twin, counts the same flops and bytes on the card as on the CPU:
    its declared cost, once, and nothing of what runs inside it."""
    from _torch_roofline import kernel_calls
    from repro_torch.analysis import measure_cost
    got = {}
    for dev in ("cpu", cuda_device):
        wrap, plain, args, kw, pargs, pkw, want = kernel_calls(dev)[name]
        before = dict(kernels.LAUNCHES)
        for fn, a, k in ((wrap, args, kw), (plain, pargs, pkw)):
            c = measure_cost(fn, *a, **k)
            got[(str(dev), fn.__name__)] = (c.flops, c.bytes)
        launched = kernels.LAUNCHES[name] - before[name]
        assert launched == (0 if dev == "cpu" else 1), (name, dev)
    assert set(got.values()) == {tuple(map(float, want))}, got


def test_analyze_run_on_card(cuda_device):
    """A corrected MVM's kernel pair under ``analyze_run``: device time,
    each kernel function's launches equal to the change of
    ``kernels.LAUNCHES`` over the counted run, no reading over 1.05 of the
    bound."""
    from repro_torch.analysis import analyze_run
    m, k = 4096, 4096
    at, da = randn((m, k), 0, cuda_device), randn((m, k), 1, cuda_device)
    x, xt = randn((k, 1), 2, cuda_device), randn((k, 1), 3, cuda_device)

    def call(at, da, x, xt):
        return kernels.stencil_denoise(kernels.ec_matmul(at, da, x, xt),
                                       1e-2)

    before = dict(kernels.LAUNCHES)
    rec = analyze_run(call, at, da, x, xt)
    twice = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    assert rec["device_ms"] > 0
    assert set(rec["by_kernel"]) == {"ec_matmul", "stencil_denoise"}
    for name, row in rec["by_kernel"].items():
        assert row["calls"] == row["launches"] == 1
        assert 2 * row["launches"] == twice[name]   # peak run + counted run
        assert row["device_ms"] > 0 and row["achieved"] <= 1.05, row
    assert rec["dominant"] == "memory"
    assert 0 < rec["achieved"] <= 1.05
    assert rec["memory"]["peak_bytes"] > 0 and rec["memory"]["fits_hbm"]


def test_analyze_run_raises_without_device_time(cuda_device, monkeypatch):
    """A CUDA call under a profile that records no device activity raises:
    no record goes without its device time."""
    from repro_torch.analysis import analyze_run, roofline
    monkeypatch.setattr(roofline, "_ACTIVITIES", ("CPU",))
    p = randn((4096, 1), 0, cuda_device)
    with pytest.raises(RuntimeError, match="no device time"):
        analyze_run(lambda q: kernels.stencil_denoise(q, 1e-2), p)
