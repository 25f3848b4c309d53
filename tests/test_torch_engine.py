"""The port's engine held to the JAX engine: program + corrected MVM on both
backends with the reference's noise injected, a JAX-programmed image
carried across and executed by both packages, the handle API, the
call-counter key schedule, and the local-only guard."""
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
    for _ in range(2):
        eng = AnalogEngine(pcfg, backend="cuda", device="cpu")
        A = eng.program(a, 4)
        runs.append([A @ x, A @ x, eng.mvm(A, x, key=123)])
        assert A.calls == 3
    assert not torch.equal(runs[0][0], runs[0][1])
    for got, want in zip(runs[1], runs[0]):
        assert torch.equal(got, want)


def test_guards():
    _, pcfg = configs()
    for mode, item in [("streamed", "Queue A7"), ("distributed", "Queue A11")]:
        with pytest.raises(NotImplementedError, match=item):
            AnalogEngine(pcfg, execution=mode, device="cpu")
    with pytest.raises(ValueError):
        AnalogEngine(pcfg, execution="nope", device="cpu")
    with pytest.raises(ValueError):
        AnalogEngine(pcfg, backend="pallas", device="cpu")
    _, thomas = configs(denoise_method="thomas")
    eng = AnalogEngine(thomas, backend="cuda", device="cpu")
    A = eng.program(np.eye(40, dtype=np.float32), 0)
    with pytest.raises(NotImplementedError, match="Queue B1"):
        A @ np.ones(40, np.float32)
    other = AnalogEngine(dataclasses.replace(thomas, k_iters=2), device="cpu")
    with pytest.raises(ValueError):
        other.mvm(A, np.ones(40, np.float32))
