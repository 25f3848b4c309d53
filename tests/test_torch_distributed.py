"""The port's distributed placement held to the JAX package's.

The JAX side needs a mesh of 8 devices, which exists only under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``: ONE child process
for this module (a module-scoped fixture) runs every reference case and
writes its arrays to an ``.npz``; the tests compare in this process.  The
port runs the same inputs (numpy, fixed seeds) on a CPU mesh with the
reference's draws injected as ``eta``: per rank under the rank's device key
(``fold_in`` of its mesh indices) for the dense and grouped placements, per
global block for the producer placement.  Both port backends (``cuda`` on
CPU tensors runs the kernels' plain versions) are held to the JAX reference
backend to 1e-5 rel-L2, with equal write costs.  Within the port, a 1 x 1
producer mesh is the streamed engine bit for bit in both directions.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import (block_dac_eta, few_threads,  # noqa: F401
                         program_eta, rel, rng_array, to_np)
from repro.core import crossbar as jcb
from repro.core import devices as jdev
from repro.core import virtualization as jvirt
from repro_torch import solvers as tsol
from repro_torch.core import denoise_least_square
from repro_torch.core import distributed as tdist
from repro_torch.core.prng import fold_in
from repro_torch.engine import AnalogEngine
from repro_torch.interop import config_from_dict
from repro_torch.launch import (axis_index, make_mesh, make_production_mesh,
                                mesh_axis_sizes, psum)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
M, N = 192, 320          # a 2 x 4 mesh cuts it into 96 x 80 windows
P = 256                  # the producer: 4 x 4 capacity blocks of 64^2
KEY, K2 = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
MESHES = {"2x4": (2, 4), "1x1": (1, 1), "2x1": (2, 1), "1x4": (1, 4)}
LAM = {"lam": 1e-2}      # tier-2 visible in fp32, so its segment cuts show
DENSE = {
    "2x4": ("2x4", LAM),
    "1x1": ("1x1", LAM),
    "2x1": ("2x1", LAM),
    "1x4": ("1x4", LAM),
}
PRODUCER = {"2x4": ("2x4", True), "2x4-nonresident": ("2x4", False),
            "1x1": ("1x1", True)}

CHILD = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from repro import solvers
    from repro.core import (CrossbarConfig, MCAGeometry, get_device,
                            distributed_corrected_mvm)
    from repro.engine import AnalogEngine
    from repro.launch.mesh import make_mesh

    def rng(shape, seed, scale=1.0):
        return (np.random.default_rng(seed).standard_normal(shape)
                * scale).astype(np.float32)

    def cfg_of(device="taox-hfox", **kw):
        return CrossbarConfig(device=get_device(device),
                              geom=MCAGeometry(2, 2, 32, 32), **kw)

    KEY, K2 = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    M, N, P = {M}, {N}, {P}
    MESHES, DENSE, PRODUCER = {MESHES}, {DENSE}, {PRODUCER}
    out = {{}}

    def put(name, v):
        out[name] = np.asarray(v)

    def stats(name, st):
        out[name] = np.array([float(st.energy_j), float(st.latency_s)])

    meshes = {{k: make_mesh(v, ("data", "model")) for k, v in MESHES.items()}}
    a, x, y = rng((M, N), 90), rng((N, 2), 91), rng((M, 2), 92)
    for name, (mesh, kw) in DENSE.items():
        eng = AnalogEngine(cfg_of(**kw), execution="distributed",
                           mesh=meshes[mesh])
        A = eng.program(jnp.asarray(a), KEY)
        put(name + "/at", A.at_dense)
        put(name + "/da", A.da_dense)
        stats(name + "/write", A.write_stats)
        got, st = eng.mvm_with_stats(A, jnp.asarray(x))
        put(name + "/mvm", got)
        stats(name + "/mvm_stats", st)
        got, st = eng.rmvm_with_stats(A, jnp.asarray(y), key=K2)
        put(name + "/rmvm", got)
        stats(name + "/rmvm_stats", st)

    p = rng((P, P), 93)
    blocks = jnp.asarray(p.reshape(4, 64, 4, 64).transpose(0, 2, 1, 3))
    xp, yp = rng((P, 2), 94), rng((P, 2), 95)
    for name, (mesh, resident) in PRODUCER.items():
        eng = AnalogEngine(cfg_of(lam=1e-2), execution="distributed",
                           mesh=meshes[mesh])
        A = eng.program(lambda i, j: blocks[i, j], KEY, shape=(P, P),
                        resident=resident)
        if resident:
            put("p" + name + "/at", A.at_blocks)
        stats("p" + name + "/write", A.write_stats)
        put("p" + name + "/mvm", A @ jnp.asarray(xp))
        put("p" + name + "/rmvm", eng.rmvm(A, jnp.asarray(yp),
                                           key=K2 if resident else KEY))

    eng = AnalogEngine(cfg_of(lam=1e-2), execution="distributed",
                       mesh=meshes["2x4"])
    stack = rng((3, M, N), 96)
    G = eng.program_group(jnp.asarray(stack), KEY)
    put("group/at", G.at_dense)
    put("group/da", G.da_dense)
    stats("group/write", G.write_stats)
    got, st = eng.group_mvm_with_stats(G, jnp.asarray(x))
    put("group/mvm", got)
    stats("group/mvm_stats", st)
    got, st = eng.group_rmvm_with_stats(G, jnp.asarray(y), key=K2)
    put("group/rmvm", got)
    stats("group/rmvm_stats", st)
    S = AnalogEngine(cfg_of(), execution="streamed").program(
        lambda i, j: blocks[i, j], KEY, shape=(190, 318))
    for t in (False, True):
        stats("iws/" + str(t), eng.input_write_stats(S, 3, transpose=t))

    got, st = distributed_corrected_mvm(jnp.asarray(a),
                                        jnp.asarray(x[:, 0]), KEY,
                                        cfg_of(lam=1e-2), meshes["2x4"])
    put("dcm/y", got)
    stats("dcm/stats", st)

    exact = cfg_of("epiram", encode_inputs=False)
    eng = AnalogEngine(exact, execution="distributed", mesh=meshes["2x4"])
    r = rng((M, M), 97) / M
    spd = (r + r.T + 2.0 * np.eye(M)).astype(np.float32)
    b = (spd @ rng((M,), 98)).astype(np.float32)
    res = solvers.cg(eng.program(jnp.asarray(spd), KEY), jnp.asarray(b),
                     tol=1e-4, maxiter=40)
    put("cg/x", res.x)
    put("cg/iterations", res.iterations)
    la, lb, lc, _, _ = solvers.random_feasible_lp(jax.random.PRNGKey(14),
                                                  64, 64)
    step = 0.9 / float(np.linalg.norm(np.asarray(la), 2))
    res = solvers.pdhg(eng.program(la, KEY), lb, lc, tol=1e-3, maxiter=3000,
                       tau=step, sigma=step)
    put("pdhg/x", res.x)
    put("pdhg/iterations", res.iterations)
    put("pdhg/lp_a", la)
    put("pdhg/lp_b", lb)
    put("pdhg/lp_c", lc)
    np.savez(sys.argv[1], **out)
""").format(M=M, N=N, P=P, MESHES=MESHES, DENSE=DENSE, PRODUCER=PRODUCER)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every JAX reference case, from one child with 8 host devices."""
    path = tmp_path_factory.mktemp("dist") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    done = subprocess.run([sys.executable, "-c", CHILD, str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


def jcfg(device="taox-hfox", **kw):
    return jcb.CrossbarConfig(device=jdev.get_device(device),
                              geom=jvirt.MCAGeometry(2, 2, 32, 32), **kw)


def pcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def mesh(name):
    return make_mesh(MESHES[name], ("data", "model"), device="cpu")


def dev_key(key, r, c):
    """The reference's device key on a (data, model) mesh."""
    return jax.random.fold_in(jax.random.fold_in(key, r), c)


def rank_eta(key, shape, make):
    """(R, C, ...): ``make(device key)`` for every rank's window."""
    R, C = shape
    return torch.from_numpy(np.stack([np.stack([
        make(dev_key(key, r, c)) for c in range(C)]) for r in range(R)]))


def window_blocks(m, n, shape):
    R, C = shape
    return -(-(m // R) // 64), -(-(n // C) // 64)


def assert_stats(got, want):
    assert got.energy_j == pytest.approx(float(want[0]), rel=1e-6)
    assert got.latency_s == pytest.approx(float(want[1]), rel=1e-6)


def dense_handle(name, backend):
    mesh_name, kw = DENSE[name]
    cfg = jcfg(**kw)
    shape = MESHES[mesh_name]
    mbl, nbl = window_blocks(M, N, shape)
    eng = AnalogEngine(pcfg(cfg), execution="distributed",
                       mesh=mesh(mesh_name), backend=backend)
    A = eng.program(rng_array((M, N), 90), 0, eta=rank_eta(
        KEY, shape, lambda k: program_eta(k, cfg, mbl, nbl)))
    return cfg, eng, A, shape, (mbl, nbl)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("case", list(DENSE))
def test_dense_placement_matches_jax(ref, case, backend):
    """Dense placement on 2 x 4, 1 x 1, 2 x 1 and 1 x 4: the ranks' images,
    write cost, ``A @ x`` (call 0) and ``A.T @ y`` (an explicit key), each
    with its input-write cost; every window padded and keyed on its own,
    tier-2 cut at the segment edges as the reference cuts it."""
    cfg, eng, A, shape, (mbl, nbl) = dense_handle(case, backend)
    assert A.mesh_sharded and len(A.at_ranks) == shape[0] * shape[1]
    assert A.at_ranks[0].shape == (mbl * 64, nbl * 64)
    assert rel(A.a_tilde, ref[case + "/at"]) <= TOL
    assert rel(A.da, ref[case + "/da"]) <= TOL
    assert_stats(A.write_stats, ref[case + "/write"])
    x, y = rng_array((N, 2), 91), rng_array((M, 2), 92)
    got, st = eng.mvm_with_stats(A, x, eta=rank_eta(
        KEY, shape, lambda k: block_dac_eta(k, cfg, mbl, nbl, 2)))
    assert got.shape == (M, 2) and rel(got, ref[case + "/mvm"]) <= TOL
    assert_stats(st, ref[case + "/mvm_stats"])
    got, st = eng.rmvm_with_stats(A, y, eta=rank_eta(
        K2, shape, lambda k: block_dac_eta(k, cfg, mbl, nbl, 2, True)))
    assert got.shape == (N, 2) and rel(got, ref[case + "/rmvm"]) <= TOL
    assert_stats(st, ref[case + "/rmvm_stats"])


@pytest.mark.parametrize("transpose", [False, True])
def test_thomas_segments_on_both_backends(transpose):
    """The exact Thomas tier-2 on each output segment: the ``cuda`` path
    (the ``thomas_solve`` kernel's plain version here) equals the
    ``reference`` pipeline's per segment.  (The reference's own Thomas
    scan does not trace inside this jax's ``shard_map``: its carry's
    varying axes differ, so there is no JAX case for it.)"""
    cfg = pcfg(jcfg(denoise_method="thomas", lam=1e-2))
    a, u = rng_array((M, N), 90), rng_array((M if transpose else N, 2), 91)
    outs = []
    for backend in ("reference", "cuda"):
        eng = AnalogEngine(cfg, execution="distributed", mesh=mesh("2x4"),
                           backend=backend)
        A = eng.program(a, 3)
        outs.append((eng.rmvm if transpose else eng.mvm)(A, u, key=8))
    assert rel(outs[1], outs[0]) <= TOL
    # Each segment is its own system: not the Thomas solve of the whole.
    whole = denoise_least_square(outs[0], lam=1e-2, method="thomas")
    assert rel(whole, outs[0]) > 1e-6


def producer_pair():
    p = rng_array((P, P), 93)
    blocks = torch.from_numpy(np.ascontiguousarray(
        p.reshape(4, 64, 4, 64).transpose(0, 2, 1, 3)))
    return p, (lambda i, j: blocks[i, j])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("case", list(PRODUCER))
def test_producer_placement_matches_jax(ref, case, backend):
    """Producer placement, resident on 2 x 4 and 1 x 1 and non-resident on
    2 x 4, with the global block grid's draws: the joined image, the
    per-rank write cost, ``A @ x`` and ``A.T @ y`` (non-resident: at the
    base key, where the reference's re-encode draws the programmed image)."""
    mesh_name, resident = PRODUCER[case]
    cfg = jcfg(**LAM)
    _, fn = producer_pair()
    eng = AnalogEngine(pcfg(cfg), execution="distributed",
                       mesh=mesh(mesh_name), backend=backend)
    peta = torch.from_numpy(program_eta(KEY, cfg, 4, 4))
    A = eng.program(fn, 0, shape=(P, P), resident=resident, eta=peta)
    assert A.resident == resident and (A.at_ranks is None) != resident
    case = "p" + case
    if resident:
        assert rel(A.at_blocks, ref[case + "/at"]) <= TOL
    assert_stats(A.write_stats, ref[case + "/write"])
    xp, yp = rng_array((P, 2), 94), rng_array((P, 2), 95)
    got = eng.mvm(A, xp, eta=torch.from_numpy(
        block_dac_eta(KEY, cfg, 4, 4, 2)))
    assert rel(got, ref[case + "/mvm"]) <= TOL
    got = eng.rmvm(A, yp, eta=torch.from_numpy(
        block_dac_eta(K2 if resident else KEY, cfg, 4, 4, 2, True)))
    assert rel(got, ref[case + "/rmvm"]) <= TOL


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("shape", [(2, 4), (2, 1), (1, 4)])
def test_producer_meshes_equal_one_rank_and_streamed(backend, shape):
    """With the port's own draws: a 1 x 1 producer mesh is the streamed
    engine bit for bit in both directions (the global key schedule), and
    R x C meshes equal 1 x 1 to fp32 rounding where tier-2 is near the
    identity (lam 1e-12) -- exactly, when their sums run in the same order;
    ``resident=False`` equals ``resident=True`` bit for bit at every call
    (the programming draws come from the handle's key)."""
    _, pc = jcfg(), pcfg(jcfg())
    _, fn = producer_pair()
    x, y = rng_array((P, 3), 96), rng_array((P, 3), 97)
    one = AnalogEngine(pc, execution="distributed", mesh=mesh("1x1"),
                       backend=backend).program(fn, 4, shape=(P, P))
    S = AnalogEngine(pc, execution="streamed", backend=backend,
                     device="cpu").program(fn, 4, shape=(P, P))
    assert torch.equal(one @ x, S @ x) and torch.equal(one.T @ y, S.T @ y)
    grid = make_mesh(shape, ("data", "model"), device="cpu")
    eng = AnalogEngine(pc, execution="distributed", mesh=grid,
                       backend=backend)
    D = eng.program(fn, 4, shape=(P, P))
    assert torch.equal(D.at_blocks, S.at_blocks)
    for run in (eng.mvm, eng.rmvm):
        u = y if run == eng.rmvm else x
        assert rel(run(D, u, key=9), one.engine.mvm(one, u, key=9)
                   if run == eng.mvm else one.engine.rmvm(one, u, key=9)) \
            <= TOL
    nr = eng.program(fn, 4, shape=(P, P), resident=False)
    assert nr.image_nbytes == 0
    for key in (4, 5):      # the handle's key, and another call's
        assert torch.equal(eng.mvm(nr, x, key=key), eng.mvm(D, x, key=key))
        assert torch.equal(eng.rmvm(nr, y, key=key), eng.rmvm(D, y, key=key))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_group_placement_matches_jax(ref, backend):
    """A 3-member stack over 2 x 4: images, write cost, group_mvm (call 0)
    and group_rmvm (an explicit key) with their input-write costs; the
    ``cuda`` backend runs one grouped EC launch per rank's window (plain
    versions here) on the same per-block draws."""
    cfg = jcfg(**LAM)
    mbl, nbl = window_blocks(M, N, (2, 4))
    eng = AnalogEngine(pcfg(cfg), execution="distributed", mesh=mesh("2x4"),
                       backend=backend)
    members = [jax.random.fold_in(KEY, g) for g in range(3)]

    def per_member(make):
        return torch.stack([rank_eta(k, (2, 4), make) for k in members])

    stack = rng_array((3, M, N), 96)
    G = eng.program_group(stack, 0, eta=per_member(
        lambda k: program_eta(k, cfg, mbl, nbl)))
    for g in range(3):
        assert rel(G.member(g).a_tilde, ref["group/at"][g]) <= TOL
        assert rel(G.member(g).da, ref["group/da"][g]) <= TOL
    assert_stats(G.write_stats, ref["group/write"])
    x, y = rng_array((N, 2), 91), rng_array((M, 2), 92)
    got, st = eng.group_mvm_with_stats(G, x, eta=per_member(
        lambda k: block_dac_eta(k, cfg, mbl, nbl, 2)))
    assert got.shape == (3, M, 2) and rel(got, ref["group/mvm"]) <= TOL
    assert_stats(st, ref["group/mvm_stats"])
    kt = [jax.random.fold_in(K2, g) for g in range(3)]
    got, st = eng.group_rmvm_with_stats(G, y, eta=torch.stack([
        rank_eta(k, (2, 4), lambda d: block_dac_eta(d, cfg, mbl, nbl, 2,
                                                    True)) for k in kt]))
    assert got.shape == (3, N, 2) and rel(got, ref["group/rmvm"]) <= TOL
    assert_stats(st, ref["group/rmvm_stats"])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_group_members_equal_solo_programs(backend):
    """Member g of a distributed group is a solo distributed program under
    ``fold_in(key, g)`` bit for bit, and executes as one."""
    pc = pcfg(jcfg(**LAM))
    eng = AnalogEngine(pc, execution="distributed", mesh=mesh("2x4"),
                       backend=backend)
    stack = rng_array((3, M, N), 98)
    G = eng.program_group(stack, 6)
    x = rng_array((N, 2), 99)
    ys = eng.group_mvm(G, x, key=11)
    for g in range(3):
        solo = eng.program(stack[g], fold_in(6, g))
        for got, want in zip(G.member(g).at_ranks + G.member(g).da_ranks,
                             solo.at_ranks + solo.da_ranks):
            assert torch.equal(got, want)
        assert rel(ys[g], eng.mvm(solo, x, key=fold_in(11, g))) <= TOL
    assert G.image_nbytes == sum(t.nbytes for t in G.at_ranks + G.da_ranks)


def test_distributed_corrected_mvm_matches_jax(ref):
    """The one-shot shim: program + one execute on 2 x 4, billed for both."""
    cfg = jcfg(**LAM)
    mbl, nbl = window_blocks(M, N, (2, 4))
    got, st = tdist.distributed_corrected_mvm(
        torch.from_numpy(rng_array((M, N), 90)),
        torch.from_numpy(rng_array((N, 2), 91)[:, 0]), 0, pcfg(cfg),
        mesh("2x4"),
        eta=rank_eta(KEY, (2, 4), lambda k: program_eta(k, cfg, mbl, nbl)),
        dac_eta=rank_eta(KEY, (2, 4),
                         lambda k: block_dac_eta(k, cfg, mbl, nbl, 1)))
    assert got.shape == (M,) and rel(got, ref["dcm/y"]) <= TOL
    assert_stats(st, ref["dcm/stats"])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("name", ["cg", "pdhg"])
def test_solvers_on_a_2x4_handle_match_jax(ref, name, backend):
    """CG and PDHG (steps given) on a 2 x 4 dense handle, DAC off with the
    reference's programming draws injected: the JAX distributed solve's
    iterations and x within 1e-5; the solvers see one global tensor."""
    cfg = jcfg("epiram", encode_inputs=False)
    eng = AnalogEngine(pcfg(cfg), execution="distributed", mesh=mesh("2x4"),
                       backend=backend)
    if name == "cg":
        r = rng_array((M, M), 97) / M
        a = (r + r.T + 2.0 * np.eye(M)).astype(np.float32)
        b = (a @ rng_array((M,), 98)).astype(np.float32)
    else:
        a, b, c = (ref["pdhg/lp_" + k] for k in "abc")
        step = 0.9 / float(np.linalg.norm(a, 2))
    mbl, nbl = window_blocks(*a.shape, (2, 4))
    A = eng.program(a, 0, eta=rank_eta(
        KEY, (2, 4), lambda k: program_eta(k, cfg, mbl, nbl)))
    if name == "cg":
        res = tsol.cg(A, b, tol=1e-4, maxiter=40)
    else:
        res = tsol.pdhg(A, b, c, tol=1e-3, maxiter=3000, tau=step,
                        sigma=step)
    assert res.converged
    assert res.iterations == int(ref[name + "/iterations"]) > 2
    assert rel(res.x, ref[name + "/x"]) <= TOL


def test_input_write_stats_and_collective_axes(ref):
    """A distributed engine bills one rank's ceil-divided footprint (here a
    190 x 318 handle over 2 x 4), forward and transposed; its collective
    axes are the row axes and the column axis; other engines have none."""
    pc = pcfg(jcfg())
    eng = AnalogEngine(pc, execution="distributed", mesh=mesh("2x4"))
    S = AnalogEngine(pc, execution="streamed", device="cpu").program(
        lambda i, j: torch.zeros(64, 64), 0, shape=(190, 318))
    for t in (False, True):
        assert_stats(eng.input_write_stats(S, 3, transpose=t),
                     ref["iws/" + str(t)])
    assert eng.collective_axes == ("data", "model")
    pod = AnalogEngine(pc, execution="distributed", row_axes=("pod", "data"),
                       mesh=make_mesh((1, 2, 4), ("pod", "data", "model"),
                                      device="cpu"))
    assert pod.collective_axes == ("pod", "data", "model")
    assert AnalogEngine(pc, device="cpu").collective_axes == ()
    assert AnalogEngine(pc, execution="streamed",
                        device="cpu").collective_axes == ()


def test_mesh_ranks_and_psum():
    """Row-major ranks, axis indices and sizes, the production topology,
    and psum: each group's partials added in rank order, shared by the
    group's ranks."""
    m = make_mesh((2, 4), ("data", "model"), device="cpu")
    assert m.size == 8 and mesh_axis_sizes(m) == {"data": 2, "model": 4}
    assert [m.coords(r) for r in (0, 5)] == [{"data": 0, "model": 0},
                                             {"data": 1, "model": 1}]
    assert all(m.rank(m.coords(r)) == r for r in range(8))
    assert axis_index(m, 6, "model") == 2 and axis_index(m, 6, "data") == 1
    parts = [torch.full((2,), float(r)) for r in range(8)]
    rows = psum(m, parts, "model")
    assert torch.equal(rows[1], torch.full((2,), 6.0)) and rows[0] is rows[3]
    assert torch.equal(rows[4], torch.full((2,), 22.0))
    cols = psum(m, parts, ("data",))
    assert torch.equal(cols[2], torch.full((2,), 8.0)) and cols[2] is cols[6]
    assert torch.equal(psum(m, parts, ("data", "model"))[7],
                       torch.full((2,), 28.0))
    big = make_production_mesh(device="cpu")
    assert big.shape == (16, 16) and big.axis_names == ("data", "model")
    pods = make_production_mesh(multi_pod=True, device="cpu")
    assert pods.shape == (2, 16, 16) and pods.lead_device.type == "cpu"
    with pytest.raises(ValueError, match="one partial per rank"):
        psum(m, parts[:7], "model")
    with pytest.raises(ValueError, match="not axes"):
        psum(m, parts, "pod")


def test_shard_matrix_windows():
    """Windows are contiguous, in rank order, and tile the matrix."""
    a = torch.arange(8 * 12, dtype=torch.float32).view(8, 12)
    w = tdist.shard_matrix(a, mesh("2x4"))
    assert len(w) == 8 and all(t.is_contiguous() for t in w)
    assert torch.equal(w[5], a[4:8, 3:6])
    assert tdist.mesh_grid_shape(mesh("2x4"), ("data",), "model") == (2, 4)
    stacked = tdist.shard_matrix(torch.stack([a, -a]), mesh("2x4"))
    assert torch.equal(stacked[5][1], -a[4:8, 3:6])
    with pytest.raises(ValueError, match="does not divide"):
        tdist.shard_matrix(a[:, :10], mesh("2x4"))


def test_validation_errors():
    """Every refusal of the distributed placement, each with its reason."""
    pc = pcfg(jcfg())
    with pytest.raises(ValueError, match="requires a mesh"):
        AnalogEngine(pc, execution="distributed", device="cpu")
    with pytest.raises(ValueError, match="A16"):
        make_mesh((1, 2), ("data", "model"), device=["cpu", "meta"])
    with pytest.raises(ValueError, match="distinct axes"):
        AnalogEngine(pc, execution="distributed", mesh=mesh("2x4"),
                     col_axis="pod")
    with pytest.raises(ValueError, match="neither row axes"):
        AnalogEngine(pc, execution="distributed", row_axes=("data",),
                     mesh=make_mesh((2, 2, 4), ("pod", "data", "model"),
                                    device="cpu"))
    with pytest.raises(ValueError, match="lead device"):
        AnalogEngine(pc, execution="distributed", mesh=mesh("2x4"),
                     device="meta")
    eng = AnalogEngine(pc, execution="distributed", mesh=mesh("2x4"))
    _, fn = producer_pair()
    with pytest.raises(ValueError, match="does not divide over"):
        eng.program(fn, 0, shape=(3 * 64, P))
    with pytest.raises(ValueError, match="multiple of the capacity row"):
        eng.program(fn, 0, shape=(P - 2, P))
    with pytest.raises(ValueError, match="multiple of the capacity column"):
        eng.program(fn, 0, shape=(P, P - 2))
    with pytest.raises(ValueError, match="requires shape"):
        eng.program(fn, 0)
    with pytest.raises(ValueError, match="does not divide"):
        eng.program(rng_array((M + 1, N), 1), 0)
    with pytest.raises(ValueError, match="resident=False requires a block_fn"):
        eng.program(rng_array((M, N), 1), 0, resident=False)
    streamed = AnalogEngine(pc, execution="streamed", device="cpu")
    with pytest.raises(ValueError, match="resident=False requires "
                                         "execution='distributed'"):
        streamed.program(fn, 0, shape=(P, P), resident=False)
    S = streamed.program(fn, 0, shape=(P, P))
    D = eng.program(fn, 0, shape=(P, P))
    with pytest.raises(ValueError, match="executes distributed"):
        eng.mvm(S, rng_array((P,), 2))
    with pytest.raises(ValueError, match="mesh-sharded"):
        streamed.mvm(D, rng_array((P,), 2))
    with pytest.raises(ValueError, match="mesh-sharded"):
        AnalogEngine(pc, device="cpu").rmvm(D, rng_array((P,), 2))
    other = AnalogEngine(pc, execution="distributed", mesh=mesh("1x4"))
    with pytest.raises(ValueError, match="another mesh"):
        other.mvm(D, rng_array((P,), 2))
    with pytest.raises(ValueError, match="producer groups"):
        eng.program_group([fn, fn], 0, shape=(P, P))
    with pytest.raises(ValueError, match="program_group"):
        streamed.group([D])
    G = eng.program_group(rng_array((2, M, M), 3), 0)
    with pytest.raises(ValueError, match="LOCAL resident group"):
        eng.chain_mvm(G, rng_array((M,), 4))
    with pytest.raises(ValueError, match="mesh-sharded"):
        streamed.group_mvm(G, rng_array((M,), 4))
    L = AnalogEngine(pc, device="cpu").program_group(
        rng_array((2, M, M), 3), 0)
    with pytest.raises(ValueError, match="executes distributed"):
        eng.group_mvm(L, rng_array((M,), 4))
    with pytest.raises(ValueError, match="A @ x"):
        eng.mvm(D, rng_array((P + 1,), 5))
    with pytest.raises(ValueError, match="non-resident"):
        tdist.make_distributed_streamed_mvm(
            fn, pc, mesh("2x4"), m=P, n=P, mb=4, nb=4, resident=False)(
            D.at_ranks, torch.zeros(P, 1), 0)


def test_handle_views_and_residency():
    """The views of a distributed handle: joined images, the exact source
    by one producer sweep, bytes held per placement (0 for a non-resident
    handle, whose image views are a fresh sweep)."""
    pc = pcfg(jcfg())
    eng = AnalogEngine(pc, execution="distributed", mesh=mesh("2x4"))
    a = rng_array((M, N), 7)
    A = eng.program(a, 1)
    assert A.at_blocks is None and A.da_blocks is None
    assert A.image_nbytes == 2 * 8 * 128 * 128 * 4
    assert rel(A.dense(), a) <= 1e-6
    p, fn = producer_pair()
    D = eng.program(fn, 1, shape=(P, P))
    nr = eng.program(fn, 1, shape=(P, P), resident=False)
    np.testing.assert_array_equal(to_np(D.dense()), p)
    assert torch.equal(nr.a_tilde, D.a_tilde) and rel(D.da, p - to_np(
        D.a_tilde)) <= 1e-6
    assert D.image_nbytes == P * P * 4 and nr.image_nbytes == 0
    assert D.at_ranks[3].shape == (2, 1, 64, 64)
