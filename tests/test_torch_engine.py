"""The port's engine held to the JAX engine: program + corrected MVM and
transposed MVM (``A.T @ y``) on both backends with the reference's noise
injected, the exact Thomas tier-2 on the kernel backend, a JAX-programmed
image carried across and executed by both packages, the handle API and the
transposed view, the call-counter key schedule, and the guards (streamed
execution constructs, distributed placement is not ported)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (block_dac_eta, few_threads, program_eta,  # noqa: F401
                         rel, rng_array, to_np, whole_dac_eta)
from repro.core import crossbar as jcb
from repro.core import devices as jdev
from repro.core import virtualization as jvirt
from repro.engine import AnalogEngine as JaxEngine
from repro_torch.engine import AnalogEngine
from repro_torch.interop import config_from_dict, image_from_numpy
from repro_torch.launch import make_mesh

TOL = 1e-5
M, N, BATCH = 150, 130, 3


def configs(**kw):
    cfg = jcb.CrossbarConfig(device=jdev.get_device("taox-hfox"),
                             geom=jvirt.MCAGeometry(2, 2, 32, 32), **kw)
    return cfg, config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def problem():
    return rng_array((M, N), 20), rng_array((N, BATCH), 21)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_program_and_mvm_match_with_injected_eta(problem, backend):
    """Programming noise and DAC noise drawn in the reference's schedule:
    block keys -> split for the image; per-block k_x halves for the
    reference backend; one whole-vector fold-1 draw for the kernel backend
    (the JAX engine's ``backend="pallas"``)."""
    a, x = problem
    cfg, pcfg = configs()
    key = jax.random.PRNGKey(11)
    jeng = JaxEngine(cfg, backend="pallas" if backend == "cuda"
                     else "reference")
    ja = jeng.program(jnp.asarray(a), key)
    want = ja @ jnp.asarray(x)                       # call 0 uses the base key
    mb, nb = ja.at_blocks.shape[:2]
    eng = AnalogEngine(pcfg, backend=backend, device="cpu")
    A = eng.program(a, 0, eta=torch.from_numpy(program_eta(key, cfg, mb, nb)))
    assert rel(A.at_blocks, ja.at_blocks) <= TOL
    assert rel(A.a_tilde, ja.a_tilde) <= TOL and rel(A.da, ja.da) <= TOL
    if backend == "cuda":
        eta = whole_dac_eta(key, nb * pcfg.geom.capacity[1], BATCH)
    else:
        eta = block_dac_eta(key, cfg, mb, nb, BATCH)
    got = eng.mvm(A, x, eta=torch.from_numpy(eta))
    assert got.shape == (M, BATCH)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("kw", [{}, {"denoise_method": "thomas", "lam": 1e-2}])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_rmvm_matches_with_injected_eta(problem, backend, kw):
    """``A.T @ y`` on both backends against the JAX engine (``"cuda"`` vs
    its ``backend="pallas"``): the kernel backend's one whole-vector DAC
    draw is fold 2 of the call key, the reference backend's per-block draws
    are the forward k_x halves over row chunks.  Also with the exact Thomas
    tier-2 at lam = 1e-2 (at the engine's 1e-12 it is the identity)."""
    a, _ = problem
    y = rng_array((M, BATCH), 22)
    cfg, pcfg = configs(**kw)
    key = jax.random.PRNGKey(13)
    jeng = JaxEngine(cfg, backend="pallas" if backend == "cuda"
                     else "reference")
    ja = jeng.program(jnp.asarray(a), key)
    want = ja.T @ jnp.asarray(y)                     # call 0: the base key
    mb, nb = ja.at_blocks.shape[:2]
    eng = AnalogEngine(pcfg, backend=backend, device="cpu")
    A = eng.program(a, 0, eta=torch.from_numpy(program_eta(key, cfg, mb, nb)))
    if backend == "cuda":
        eta = whole_dac_eta(key, mb * pcfg.geom.capacity[0], BATCH,
                            transpose=True)
    else:
        eta = block_dac_eta(key, cfg, mb, nb, BATCH, transpose=True)
    got = eng.rmvm(A, y, eta=torch.from_numpy(eta))
    assert got.shape == (N, BATCH)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("transpose", [False, True])
def test_thomas_on_kernel_backend_matches_pallas(problem, transpose):
    """``denoise_method="thomas"`` on ``backend="cuda"`` runs the
    ``thomas_solve`` kernel (its plain version here) and equals the JAX
    pallas engine's Thomas kernel path, both directions, DAC off."""
    a, x = problem
    cfg, pcfg = configs(denoise_method="thomas", lam=1e-2,
                        encode_inputs=False)
    ja = JaxEngine(cfg, backend="pallas").program(jnp.asarray(a),
                                                  jax.random.PRNGKey(3))
    A = image_from_numpy(np.asarray(ja.at_blocks), np.asarray(ja.da_blocks),
                         ja.shape, pcfg, "cpu", backend="cuda")
    u = rng_array((M, BATCH), 23) if transpose else x
    want = (ja.T if transpose else ja) @ jnp.asarray(u)
    got = (A.T if transpose else A) @ torch.from_numpy(u)
    assert rel(got, want) <= TOL
    neumann = dataclasses.replace(pcfg, denoise_method="neumann")
    B = image_from_numpy(np.asarray(ja.at_blocks), np.asarray(ja.da_blocks),
                         ja.shape, neumann, "cpu", backend="cuda")
    assert rel(got, (B.T if transpose else B) @ torch.from_numpy(u)) > 1e-4


def test_transposed_view_and_stats(problem):
    """``A.T``: shapes, ``A.T.T is A``, the shared write cost, ``dense``,
    the view executing as the other direction, direction-named shape
    errors, and the transposed per-call bill equal to the JAX engine's on a
    non-square geometry (where the two directions differ)."""
    a, x = problem
    cfg = jcb.CrossbarConfig(device=jdev.get_device("taox-hfox"),
                             geom=jvirt.MCAGeometry(2, 2, 32, 16))
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    ja = JaxEngine(cfg).program(jnp.asarray(a), jax.random.PRNGKey(0))
    eng = AnalogEngine(pcfg, device="cpu")
    A = eng.program(a, 0)
    assert A.T.shape == (N, M) and A.T.T is A
    assert (A.T.m, A.T.n) == (N, M) and A.T.engine is eng
    assert A.T.write_stats is A.write_stats
    assert rel(A.T.dense(), a.T) <= 1e-6
    y = rng_array((M,), 24)
    assert torch.equal(eng.mvm(A.T, y, key=5), eng.rmvm(A, y, key=5))
    assert torch.equal(eng.rmvm(A.T, x[:, 0], key=5),
                       eng.mvm(A, x[:, 0], key=5))
    with pytest.raises(ValueError, match="A.T @ y"):
        eng.rmvm(A, x[:, 0])
    with pytest.raises(ValueError, match="A @ x"):
        eng.mvm(A, y)
    other = AnalogEngine(dataclasses.replace(pcfg, k_iters=2), device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        other.mvm(A.T, y)
    for batch in (1, 2):
        want = ja.T.input_write_stats(batch)
        got = A.T.input_write_stats(batch)
        assert np.float32(got.energy_j) == want.energy_j
        assert np.float32(got.latency_s) == want.latency_s
    assert A.T.input_write_stats(2).energy_j != A.input_write_stats(2).energy_j
    z, stats = eng.rmvm_with_stats(A, rng_array((M, 2), 25))
    assert z.shape == (N, 2)
    want = JaxEngine(cfg).rmvm_with_stats(ja, jnp.asarray(rng_array((M, 2),
                                                                    25)))[1]
    assert np.float32(stats.energy_j) == want.energy_j


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_carried_image_matches_both_packages(problem, backend):
    """A JAX-programmed image carried across by ``image_from_numpy`` and
    executed without input encoding is deterministic in both packages."""
    a, x = problem
    cfg, pcfg = configs(encode_inputs=False)
    ja = JaxEngine(cfg).program(jnp.asarray(a), jax.random.PRNGKey(2))
    A = image_from_numpy(np.asarray(ja.at_blocks), np.asarray(ja.da_blocks),
                         ja.shape, pcfg, "cpu", backend=backend)
    got = A @ torch.from_numpy(x)
    for jb in ("reference", "pallas"):
        assert rel(got, JaxEngine(cfg, backend=jb).mvm(ja, jnp.asarray(x))) \
            <= TOL
    # The carried image reassembles the JAX handle's dense views.
    np.testing.assert_array_equal(to_np(A.a_tilde), np.asarray(ja.a_tilde))
    assert rel(A.dense(), a) <= 1e-6
    # ... and reads backwards the same in both packages.
    y = rng_array((M, BATCH), 26)
    got = A.T @ torch.from_numpy(y)
    for jb in ("reference", "pallas"):
        assert rel(got, JaxEngine(cfg, backend=jb).rmvm(ja, jnp.asarray(y))) \
            <= TOL


def test_handle_api_and_stats(problem):
    a, x = problem
    cfg, pcfg = configs()
    jeng = JaxEngine(cfg)
    ja = jeng.program(jnp.asarray(a), jax.random.PRNGKey(0))
    eng = AnalogEngine(pcfg, device="cpu")
    A = eng.program(torch.from_numpy(a), 0)
    cap = pcfg.geom.capacity
    assert A.shape == (M, N) and A.at_pad.shape == (3 * cap[0], 3 * cap[1])
    assert A.image_nbytes == 2 * 4 * A.at_pad.numel()
    assert A.release() == 0
    assert A.at_blocks.data_ptr() == A.at_pad.data_ptr()   # a view, no copy
    assert A.write_stats.energy_j == pytest.approx(
        float(ja.write_stats.energy_j), rel=1e-6)
    y, stats = eng.mvm_with_stats(A, x)
    want = jeng.mvm_with_stats(ja, jnp.asarray(x))[1]
    assert y.shape == (M, BATCH)
    assert stats.energy_j == pytest.approx(float(want.energy_j), rel=1e-6)
    assert A.input_write_stats(2).latency_s == pytest.approx(
        float(ja.input_write_stats(2).latency_s), rel=1e-6)
    assert (A @ x[:, 0]).shape == (M,)
    assert rel(eng.encode_dense(a, 0), A.a_tilde) == 0.0
    with pytest.raises(ValueError):
        A @ x[:-1]


def test_call_counter_key_schedule(problem):
    """Call c draws from the base key (c = 0) or fold_in(base, c): successive
    calls differ, a re-programmed handle replays them, key= overrides."""
    a, x = problem
    _, pcfg = configs()
    runs = []
    y = rng_array((M, BATCH), 27)
    for _ in range(2):
        eng = AnalogEngine(pcfg, backend="cuda", device="cpu")
        A = eng.program(a, 4)
        runs.append([A @ x, A @ x, eng.mvm(A, x, key=123), A.T @ y])
        assert A.calls == 4           # one counter for both directions
    assert not torch.equal(runs[0][0], runs[0][1])
    for got, want in zip(runs[1], runs[0]):
        assert torch.equal(got, want)


def test_guards():
    _, pcfg = configs()
    # Streamed and distributed execution construct; distributed needs a
    # mesh (tests/test_torch_distributed.py holds it to the JAX package).
    assert AnalogEngine(pcfg, execution="streamed",
                        device="cpu").execution == "streamed"
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    dist = AnalogEngine(pcfg, execution="distributed", mesh=mesh)
    assert dist.execution == "distributed" and dist.device == mesh.lead_device
    with pytest.raises(ValueError, match="requires a mesh"):
        AnalogEngine(pcfg, execution="distributed", device="cpu")
    with pytest.raises(ValueError):
        AnalogEngine(pcfg, execution="nope", device="cpu")
    with pytest.raises(ValueError):
        AnalogEngine(pcfg, backend="pallas", device="cpu")
    # denoise_method="thomas" runs on the kernel backend (no guard) and
    # equals the JAX pallas engine.
    jcfg, thomas = configs(denoise_method="thomas", lam=1e-2,
                           encode_inputs=False)
    eye = np.eye(40, dtype=np.float32)
    eng = AnalogEngine(thomas, backend="cuda", device="cpu")
    A = eng.program(eye, 0)
    ja = JaxEngine(jcfg, backend="pallas").program(jnp.asarray(eye),
                                                   jax.random.PRNGKey(0))
    ones = np.ones(40, np.float32)
    jwant = ja @ jnp.asarray(ones)
    B = image_from_numpy(np.asarray(ja.at_blocks), np.asarray(ja.da_blocks),
                         ja.shape, thomas, "cpu", backend="cuda")
    assert rel(B @ torch.from_numpy(ones), jwant) <= TOL
    assert (A @ ones).shape == (40,)
    other = AnalogEngine(dataclasses.replace(thomas, k_iters=2), device="cpu")
    with pytest.raises(ValueError):
        other.mvm(A, np.ones(40, np.float32))
