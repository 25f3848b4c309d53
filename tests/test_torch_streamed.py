"""The port's streamed execution held to the JAX streamed engine: a
``block_fn(i, j)`` producer programs the image (only ``A_tilde`` is kept)
and every execute derives ``dA`` again per block.  With the reference's
programming and per-block DAC draws injected, both backends (``cuda`` on
CPU tensors runs the kernels' plain versions, against the JAX ``pallas``
backend in interpret mode) agree with the JAX engine in both directions, on
the one-shot stages, a windowed sweep, groups and solves; within the port,
streamed equals local bit for bit on the reference backend."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (block_dac_eta, few_threads,  # noqa: F401
                         group_block_dac_eta, group_program_eta, program_eta,
                         rel, rng_array, to_np)
from repro import solvers as jsol
from repro.core import crossbar as jcb
from repro.core import devices as jdev
from repro.core import virtualization as jvirt
from repro.engine import AnalogEngine as JaxEngine
from repro_torch import solvers as tsol
from repro_torch.core import crossbar
from repro_torch.core.prng import fold_in
from repro_torch.engine import AnalogEngine
from repro_torch.interop import config_from_dict

TOL = 1e-5
M, N = 300, 260          # 5 x 5 capacity blocks of 64^2 (2 x 2 MCAs of 32^2)
KEY = jax.random.PRNGKey(21)


def configs(device="taox-hfox", **kw):
    cfg = jcb.CrossbarConfig(device=jdev.get_device(device),
                             geom=jvirt.MCAGeometry(2, 2, 32, 32), **kw)
    return cfg, config_from_dict(dataclasses.asdict(cfg))


def padded_blocks(a, cap=64):
    """(mb, nb, cap, cap) blocks of the zero-padded ``a`` (numpy)."""
    mb, nb = -(-a.shape[0] // cap), -(-a.shape[1] // cap)
    pad = np.zeros((mb * cap, nb * cap), np.float32)
    pad[:a.shape[0], :a.shape[1]] = a
    return np.ascontiguousarray(
        pad.reshape(mb, cap, nb, cap).transpose(0, 2, 1, 3))


def producers(a):
    """The same producer in both packages: block (i, j) of the padded
    source (a torch view for the port, so it must not be written)."""
    blocks = padded_blocks(a)
    jblocks, tblocks = jnp.asarray(blocks), torch.from_numpy(blocks.copy())
    return (lambda i, j: jblocks[i, j]), (lambda i, j: tblocks[i, j]), blocks


@pytest.fixture(scope="module")
def problem():
    return rng_array((M, N), 70)


def jax_and_port(a, cfg, pcfg, backend):
    jfn, tfn, blocks = producers(a)
    jeng = JaxEngine(cfg, execution="streamed",
                     backend="pallas" if backend == "cuda" else "reference")
    ja = jeng.program(jfn, KEY, shape=a.shape)
    eng = AnalogEngine(pcfg, execution="streamed", backend=backend,
                       device="cpu")
    A = eng.program(tfn, 0, shape=a.shape, eta=torch.from_numpy(
        program_eta(KEY, cfg, *blocks.shape[:2])))
    return ja, A, blocks


CASES = {
    "neumann-b1": ({}, 1),
    "neumann-b3": ({}, 3),
    "thomas-b3": ({"denoise_method": "thomas", "lam": 1e-2}, 3),
    "ec-off-b3": ({"ec": False}, 3),
    "faithful-b3": ({"ec_mode": "faithful"}, 3),
    "dac-off-b1": ({"encode_inputs": False}, 1),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_streamed_mvm_matches_jax(problem, backend, transpose, case):
    """Call 0 of a streamed handle (the base key) in either direction, with
    the reference's programming draws and per-block DAC draws injected; the
    ``cuda`` backend against the JAX ``pallas`` streamed path (per-block EC
    kernel, tier-2 on the assembled output)."""
    kw, batch = CASES[case]
    cfg, pcfg = configs(**kw)
    ja, A, blocks = jax_and_port(problem, cfg, pcfg, backend)
    mb, nb = blocks.shape[:2]
    u = rng_array((M if transpose else N, batch), 71)
    u_in = u[:, 0] if batch == 1 else u
    want = (ja.T if transpose else ja) @ jnp.asarray(u_in)
    eta = torch.from_numpy(block_dac_eta(KEY, cfg, mb, nb, batch, transpose))
    run = A.engine.rmvm if transpose else A.engine.mvm
    got = run(A, u_in, eta=eta)
    assert got.shape == want.shape
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_streamed_image_and_views_match_jax(problem, backend):
    """The streamed image (a contiguous block stack), its dense views and
    the write cost against the JAX streamed handle; the handle keeps no
    ``dA`` and counts only its image."""
    cfg, pcfg = configs()
    ja, A, _ = jax_and_port(problem, cfg, pcfg, backend)
    assert A.streamed and A.da_blocks is None and A.da_pad is None
    assert A.at_blocks.is_contiguous() and A.at_blocks is A.at_stack
    assert rel(A.at_blocks, ja.at_blocks) <= TOL
    assert rel(A.a_tilde, ja.a_tilde) <= TOL and rel(A.da, ja.da) <= TOL
    np.testing.assert_array_equal(to_np(A.dense()), problem)
    assert A.image_nbytes == A.at_stack.nbytes == 25 * 64 * 64 * 4
    assert A.write_stats.energy_j == pytest.approx(
        float(ja.write_stats.energy_j), rel=1e-6)
    assert A.release() == 0


def test_streamed_equals_local_bit_for_bit(problem):
    """Within the port, with no injected draws: a producer that slices a
    dense source gives the image of ``program`` on that source bit for bit,
    and the ``reference`` MVM of both handles is equal under one key, in
    both directions and for a group."""
    _, pcfg = configs()
    _, tfn, _ = producers(problem)
    local = AnalogEngine(pcfg, device="cpu")
    streamed = AnalogEngine(pcfg, execution="streamed", device="cpu")
    L = local.program(problem, 5)
    S = streamed.program(tfn, 5, shape=(M, N))
    assert torch.equal(S.at_blocks, L.at_blocks)
    for batch in (1, 3):
        x, y = rng_array((N, batch), 72), rng_array((M, batch), 73)
        assert torch.equal(S @ x, L @ x)
        assert torch.equal(S.T @ y, L.T @ y)
    x = rng_array((N, 2), 74)
    G = streamed.group([S, streamed.program(tfn, 6, shape=(M, N))])
    H = local.group([L, local.program(problem, 6)])
    assert torch.equal(G.at_blocks, H.at_blocks)
    assert torch.equal(streamed.group_mvm(G, x, key=3),
                       local.group_mvm(H, x, key=3))
    # A local handle executes on a streamed engine and a streamed one on a
    # local engine, each by its own layout.
    assert torch.equal(streamed.mvm(L, x, key=9), local.mvm(S, x, key=9))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_producer_calls_and_memory_layout(problem, backend):
    """A counting producer runs exactly mb * nb times to program and mb * nb
    times per execute in either direction (with EC on; never with EC off on
    a resident image); a ``traceable`` attribute is ignored; numpy blocks
    are taken; the EC operands of every block share the stack's row
    stride."""
    _, pcfg = configs()
    blocks = padded_blocks(problem)
    calls = []

    def producer(i, j):
        calls.append((i, j))
        return blocks[i, j]                      # numpy, not a tensor

    producer.traceable = False
    eng = AnalogEngine(pcfg, execution="streamed", backend=backend,
                       device="cpu")
    A = eng.program(producer, 1, shape=(M, N))
    assert len(calls) == 25
    for run, u in ((eng.mvm, rng_array((N,), 75)),
                   (eng.rmvm, rng_array((M, 2), 76))):
        del calls[:]
        run(A, u)
        assert sorted(calls) == [(i, j) for i in range(5) for j in range(5)]
    raw = AnalogEngine(dataclasses.replace(pcfg, ec=False),
                       execution="streamed", device="cpu")
    R = raw.program(producer, 1, shape=(M, N))
    del calls[:]
    R @ rng_array((N,), 77)
    assert calls == []
    assert A.at_blocks[2, 3].stride() == (64, 1)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_oneshot_stages_match_jax(problem, transpose, use_kernel):
    """``at_blocks=None``: each block is encoded in the loop with the k_a
    half of its key and consumed at once (no resident image), against the
    JAX one-shot stage (``use_kernel`` on both sides)."""
    cfg, pcfg = configs()
    jfn, tfn, blocks = producers(problem)
    mb, nb = blocks.shape[:2]
    u = rng_array((M if transpose else N, 3), 78)
    jrun = jcb.streamed_block_rmvm if transpose else jcb.streamed_block_mvm
    want = jrun(jfn, None, jnp.asarray(u), KEY, cfg, m=M, n=N,
                use_kernel=use_kernel)
    run = crossbar.streamed_block_rmvm if transpose \
        else crossbar.streamed_block_mvm
    got = run(tfn, None, torch.from_numpy(u), 0, pcfg, m=M, n=N,
              use_kernel=use_kernel,
              eta=torch.from_numpy(block_dac_eta(KEY, cfg, mb, nb, 3,
                                                 transpose)),
              program_eta=torch.from_numpy(program_eta(KEY, cfg, mb, nb)))
    assert rel(got, want) <= TOL


def test_streamed_corrected_mvm_matches_jax_and_engine(problem):
    """The one-shot entry point against the JAX shim (injected draws,
    output and the matrix + input write cost), and, with the port's own
    draws, equal bit for bit to a streamed program + first MVM under the
    same key; the source is left as it was."""
    cfg, pcfg = configs()
    jfn, tfn, blocks = producers(problem)
    mb, nb = blocks.shape[:2]
    x = rng_array((N,), 79)
    want, jstats = jcb.streamed_corrected_mvm(jfn, jnp.asarray(x), M, N, KEY,
                                              cfg)
    got, stats = crossbar.streamed_corrected_mvm(
        tfn, torch.from_numpy(x), M, N, 0, pcfg,
        eta=torch.from_numpy(program_eta(KEY, cfg, mb, nb)),
        dac_eta=torch.from_numpy(block_dac_eta(KEY, cfg, mb, nb, 1)))
    assert got.shape == (M,) and rel(got, want) <= TOL
    assert stats.energy_j == pytest.approx(float(jstats.energy_j), rel=1e-6)
    assert stats.latency_s == pytest.approx(float(jstats.latency_s), rel=1e-6)
    once, _ = crossbar.streamed_corrected_mvm(tfn, torch.from_numpy(x), M, N,
                                              4, pcfg)
    eng = AnalogEngine(pcfg, execution="streamed", device="cpu")
    assert torch.equal(once, eng.program(tfn, 4, shape=(M, N)) @ x)
    np.testing.assert_array_equal(
        to_np(tfn(4, 4))[:M - 256, :N - 256], problem[256:, 256:])


def test_windowed_sweep_matches_full_sweep_and_jax(problem):
    """A (2, 3) window at block (1, 2) of the 5 x 5 grid: its image equals
    the matching blocks of the full sweep bit for bit (keys and producer
    see global indices), and its untiered partial MVM equals the JAX
    windowed stage under the matching slabs of the reference's draws."""
    cfg, pcfg = configs()
    jfn, tfn, blocks = producers(problem)
    full = crossbar.streamed_program_blocks(tfn, 8, pcfg, 5, 5,
                                            device="cpu")
    win = crossbar.streamed_program_blocks(tfn, 8, pcfg, 2, 3,
                                           block_offset=(1, 2), grid=(5, 5),
                                           device="cpu")
    assert torch.equal(win, full[1:3, 2:5])
    jwin = jcb.streamed_program_blocks(jfn, KEY, cfg, 2, 3,
                                       block_offset=(1, 2), grid=(5, 5))
    peta = program_eta(KEY, cfg, 5, 5)[1:3, 2:5]
    got = crossbar.streamed_program_blocks(
        tfn, 0, pcfg, 2, 3, block_offset=(1, 2), grid=(5, 5),
        eta=torch.from_numpy(peta), device="cpu")
    assert rel(got, jwin) <= TOL
    m, n = 2 * 64, 3 * 64
    x = rng_array((n, 2), 80)
    want = jcb.streamed_block_mvm(jfn, jwin, jnp.asarray(x), KEY, cfg, m=m,
                                  n=n, tier2=False, block_offset=(1, 2),
                                  grid=(5, 5))
    dac = block_dac_eta(KEY, cfg, 5, 5, 2)[1:3, 2:5]
    got = crossbar.streamed_block_mvm(tfn, got, torch.from_numpy(x), 0, pcfg,
                                      m=m, n=n, tier2=False,
                                      block_offset=(1, 2), grid=(5, 5),
                                      eta=torch.from_numpy(dac))
    assert rel(got, want) <= TOL
    with pytest.raises(ValueError):
        crossbar.streamed_program_blocks(tfn, 0, pcfg, 2, 3,
                                         block_offset=(4, 2), grid=(5, 5),
                                         device="cpu")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_streamed_group_matches_jax_and_solo(problem, backend):
    """``program_group`` over producers: member g is the solo streamed
    handle under ``fold_in(key, g)`` bit for bit (image and calls), and the
    grouped execute in both directions equals the JAX streamed group with
    its per-member draws injected (call 0, then an explicit key whose
    member folds are call 0's)."""
    cfg, pcfg = configs()
    size = 2
    a = [problem, rng_array((M, N), 81)]
    jp = [producers(s)[0] for s in a]
    tp = [producers(s)[1] for s in a]
    jeng = JaxEngine(cfg, execution="streamed",
                     backend="pallas" if backend == "cuda" else "reference")
    jg = jeng.program_group(jp, KEY, shape=(M, N))
    eng = AnalogEngine(pcfg, execution="streamed", backend=backend,
                       device="cpu")
    G = eng.program_group(tp, 0, shape=(M, N), eta=torch.from_numpy(
        group_program_eta(KEY, cfg, 5, 5, size)))
    assert G.streamed and G.da_blocks is None
    assert rel(G.at_blocks, jg.at_blocks) <= TOL
    x, y = rng_array((size, N, 3), 82), rng_array((size, M, 3), 83)
    want = jeng.group_mvm(jg, jnp.asarray(x))
    got = eng.group_mvm(G, x, eta=torch.from_numpy(
        group_block_dac_eta(KEY, cfg, 5, 5, 3, size)))
    assert rel(got, want) <= TOL
    want = jeng.group_rmvm(jg, jnp.asarray(y), key=KEY)
    got = eng.group_rmvm(G, y, eta=torch.from_numpy(
        group_block_dac_eta(KEY, cfg, 5, 5, 3, size, transpose=True)))
    assert rel(got, want) <= TOL
    # Within the port: member g is its solo handle, bit for bit.
    own = eng.program_group(tp, 7, shape=(M, N))
    solo = [eng.program(tp[g], fold_in(7, g), shape=(M, N))
            for g in range(size)]
    for g in range(size):
        assert torch.equal(own.at_blocks[g], solo[g].at_blocks)
        assert torch.equal(own.member(g).at_blocks, solo[g].at_blocks)
    out = eng.group_mvm(own, x)
    for g in range(size):
        assert torch.equal(out[g], eng.mvm(solo[g], x[g]))
    regrouped = eng.group(solo)
    assert torch.equal(eng.group_rmvm(regrouped, y, key=2),
                       eng.group_rmvm(own, y, key=2))


def test_streamed_guards(problem):
    """The reference's errors: a producer needs ``shape`` and a streamed
    engine, a producer group needs
    a streamed engine and a shape, ``chain_mvm`` refuses a streamed group,
    ``group()`` refuses a mix of local and streamed handles; and a block of
    the wrong size is refused."""
    _, pcfg = configs()
    _, tfn, _ = producers(problem)
    local = AnalogEngine(pcfg, device="cpu")
    eng = AnalogEngine(pcfg, execution="streamed", device="cpu")
    with pytest.raises(ValueError, match="shape"):
        eng.program(tfn, 0)
    with pytest.raises(ValueError, match="streamed"):
        local.program(tfn, 0, shape=(M, N))
    with pytest.raises(ValueError, match="streamed"):
        local.program_group([tfn, tfn], 0, shape=(M, N))
    with pytest.raises(ValueError, match="shape"):
        eng.program_group([tfn, tfn], 0)
    sq = eng.program_group([tfn, tfn], 0, shape=(256, 256))
    with pytest.raises(ValueError, match="LOCAL"):
        eng.chain_mvm(sq, rng_array((256,), 84), key=1)
    with pytest.raises(ValueError, match="all local or all streamed"):
        eng.group([eng.program(tfn, 0, shape=(M, N)),
                   local.program(problem, 0)])
    with pytest.raises(ValueError, match="capacity"):
        eng.program(lambda i, j: torch.zeros(32, 64), 0, shape=(M, N))


def test_host_input_lands_on_the_requested_device(problem):
    """The core streamed stages take the device the work runs on and move a
    producer's host (numpy) blocks there: the image, the ``dense()`` sweep
    and the group equal those of a torch producer bit for bit, with no
    default device to fall back to.  An execute runs where its input
    tensor lives, so a host array as input is refused."""
    _, pcfg = configs()
    _, tfn, blocks = producers(problem)
    nfn = lambda i, j: blocks[i, j]   # noqa: E731
    want = crossbar.streamed_program_blocks(tfn, 3, pcfg, 5, 5,
                                            device="cpu")
    got = crossbar.streamed_program_blocks(nfn, 3, pcfg, 5, 5,
                                           device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert torch.equal(got, want)
    stack = crossbar.produce_blocks(nfn, 5, 5, device="cpu")
    assert stack.dtype == torch.float32 and torch.equal(
        stack, torch.from_numpy(blocks))
    group = crossbar.grouped_streamed_program_blocks(
        [nfn, tfn], [3, 3], pcfg, 5, 5, device="cpu")
    assert torch.equal(group[0], want) and torch.equal(group[1], want)
    with pytest.raises(TypeError):
        crossbar.streamed_program_blocks(nfn, 3, pcfg, 5, 5)
    with pytest.raises(TypeError):
        crossbar.produce_blocks(nfn, 5, 5)
    x = rng_array((N, 2), 85)
    with pytest.raises(TypeError, match="torch.Tensor"):
        crossbar.streamed_block_mvm(nfn, got, x, 3, pcfg, m=M, n=N)
    with pytest.raises(TypeError, match="torch.Tensor"):
        crossbar.streamed_corrected_mvm(nfn, x, M, N, 3, pcfg)


def solve(pkg, name, A, b, c=None, step=None):
    if name == "cg":
        return pkg.cg(A, b, tol=1e-4, maxiter=40)
    if name == "richardson":
        return pkg.richardson(A, b, omega=0.4, tol=1e-4, maxiter=60)
    return pkg.pdhg(A, b, c, tol=1e-3, maxiter=3000, tau=step, sigma=step)


@pytest.mark.parametrize("name", ["cg", "richardson", "pdhg"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_solvers_on_a_streamed_handle(name, backend):
    """The port's solvers touch the image only through the engine, so a
    streamed handle needs no change to them: with the DAC off and the
    reference's programming draws injected, CG, Richardson (``omega``
    given) and PDHG (steps given) take the JAX streamed solve's iterations
    and reach its x within 1e-5; with the port's own draws, the streamed
    solve is the dense handle's (DAC on, bit for bit, on the reference
    backend; DAC off, within 1e-5, on cuda, whose local path draws one
    whole-vector DAC pass where the streamed one draws per block)."""
    c = step = None
    if name == "pdhg":
        a, b, c, _, _ = [np.array(v, np.float32) for v in
                         jsol.random_feasible_lp(jax.random.PRNGKey(14), 64,
                                                 64)]
        step = 0.9 / float(np.linalg.norm(a, 2))
    else:
        r = rng_array((192, 192), 85) / 192
        a = (r + r.T + 2.0 * np.eye(192)).astype(np.float32)
        b = (a @ rng_array((192,), 86)).astype(np.float32)
    cfg, pcfg = configs(device="epiram", encode_inputs=False)
    jfn, tfn, blocks = producers(a)
    ja = JaxEngine(cfg, execution="streamed",
                   backend="pallas" if backend == "cuda" else "reference") \
        .program(jfn, KEY, shape=a.shape)
    eng = AnalogEngine(pcfg, execution="streamed", backend=backend,
                       device="cpu")
    A = eng.program(tfn, 0, shape=a.shape, eta=torch.from_numpy(
        program_eta(KEY, cfg, *blocks.shape[:2])))
    want = solve(jsol, name, ja, jnp.asarray(b),
                 None if c is None else jnp.asarray(c), step)
    got = solve(tsol, name, A, b, c, step)
    assert got.converged and want.converged
    assert got.iterations == want.iterations > 2
    assert rel(got.x, want.x) <= TOL
    own = configs(device="epiram")[1] if backend == "reference" else pcfg
    S = AnalogEngine(own, execution="streamed", backend=backend,
                     device="cpu").program(tfn, 3, shape=a.shape)
    L = AnalogEngine(own, backend=backend, device="cpu").program(a, 3)
    s, d = solve(tsol, name, S, b, c, step), solve(tsol, name, L, b, c, step)
    assert s.iterations == d.iterations
    if backend == "reference":
        assert torch.equal(s.x, d.x)
    else:
        assert rel(s.x, d.x) <= TOL
