"""The port's one-shot and end-to-end error-corrected products held to the
JAX package: ``corrected_mvm`` with the reference's programming and
per-block DAC draws injected (rel-L2 <= 1e-5, equal ``WriteStats``), equal
to the port's ``reference``-backend program + mvm under one key, and
``corrected_matvecmul`` / ``corrected_matmul`` on the same pre-encoded
operands for every EC mode and tier-2 method."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_port import (block_dac_eta, few_threads, program_eta,  # noqa: F401
                         rel, rng_array)
from repro.core import crossbar as jcb
from repro.core import devices as jdev
from repro.core import error_correction as jec
from repro.core import virtualization as jvirt
from repro_torch.core import corrected_matmul, corrected_matvecmul, \
    corrected_mvm
from repro_torch.engine import AnalogEngine
from repro_torch.interop import config_from_dict

TOL = 1e-5
MODES = ["fused", "faithful"]
METHODS = ["dense", "thomas", "neumann"]


def configs(geom=(2, 2, 32, 32), **kw):
    cfg = jcb.CrossbarConfig(device=jdev.get_device("taox-hfox"),
                             geom=jvirt.MCAGeometry(*geom), **kw)
    return cfg, config_from_dict(dataclasses.asdict(cfg))


def assert_stats_equal(got, want):
    assert got.energy_j == pytest.approx(float(want.energy_j), rel=1e-6)
    assert got.latency_s == pytest.approx(float(want.latency_s), rel=1e-6)
    assert got.iterations == int(want.iterations)
    assert got.final_delta == pytest.approx(float(want.final_delta), rel=1e-6)


@pytest.mark.parametrize("shape,geom,batch,kw", [
    ((66, 66), (1, 1, 66, 66), None, {}),              # the paper's M1 shape
    ((150, 130), (2, 2, 32, 32), 3, {}),               # padded, non-square
    ((150, 130), (2, 2, 32, 32), None, {"ec": False}),
    ((70, 45), (2, 2, 16, 16), 2, {"ec_mode": "faithful",
                                   "denoise_method": "thomas", "lam": 1e-2}),
])
def test_corrected_mvm_matches_reference(shape, geom, batch, kw):
    """``(n,)`` and ``(n, batch)`` inputs, squeezed as the reference does."""
    cfg, pcfg = configs(geom, **kw)
    m, n = shape
    a = rng_array(shape, 70)
    x = rng_array((n,) if batch is None else (n, batch), 71)
    key = jax.random.PRNGKey(9)
    want, wstats = jcb.corrected_mvm(jnp.asarray(a), jnp.asarray(x), key, cfg)
    cap_m, cap_n = pcfg.geom.capacity
    mb, nb = -(-m // cap_m), -(-n // cap_n)
    got, stats = corrected_mvm(
        torch.from_numpy(a), torch.from_numpy(x), 0, pcfg,
        eta=torch.from_numpy(program_eta(key, cfg, mb, nb)),
        dac_eta=torch.from_numpy(block_dac_eta(key, cfg, mb, nb,
                                               batch or 1)))
    assert tuple(got.shape) == tuple(want.shape)
    assert rel(got, want) <= TOL
    assert_stats_equal(stats, wstats)


@pytest.mark.parametrize("batch", [None, 4])
def test_corrected_mvm_is_program_then_mvm(batch):
    """Under one key, the one-shot shim is the ``reference``-backend engine's
    program + first mvm, bit for bit, and bills program + one input write."""
    _, pcfg = configs()
    a = torch.from_numpy(rng_array((150, 130), 72))
    x = torch.from_numpy(rng_array((130,) if batch is None else (130, batch),
                                   73))
    got, stats = corrected_mvm(a, x, 123, pcfg)
    eng = AnalogEngine(pcfg, backend="reference", device="cpu")
    A = eng.program(a, 123)
    assert torch.equal(got, A @ x)
    want = A.write_stats.energy_j + A.input_write_stats(batch or 1).energy_j
    assert stats.energy_j == pytest.approx(want, rel=1e-12)


def operands(shape_x, shape_w, seed):
    """x, W and their encoded twins (a multiplicative perturbation)."""
    x, w = rng_array(shape_x, seed), rng_array(shape_w, seed + 1)
    xt = x * (1 + 0.05 * rng_array(shape_x, seed + 2))
    wt = w * (1 + 0.05 * rng_array(shape_w, seed + 3))
    return x, w, xt, wt


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", METHODS)
def test_corrected_matvecmul_matches_reference(mode, method):
    a, x, at, xt = operands((96, 64), (64, 3), 80)
    kw = dict(lam=1e-2, ec_mode=mode, denoise_method=method)
    want = jec.corrected_matvecmul(*map(jnp.asarray, (a, x, at, xt)), **kw)
    got = corrected_matvecmul(*map(torch.from_numpy, (a, x, at, xt)), **kw)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape_x", [(48,), (5, 48), (2, 3, 48)])
def test_corrected_matmul_matches_reference(mode, method, shape_x):
    """Row-major ``x @ W`` for x of rank 1, 2 and 3; tier-2 along the
    output-feature axis (lam 1e-2, where it is not the identity)."""
    x, w, xt, wt = operands(shape_x, (48, 40), 90)
    kw = dict(lam=1e-2, ec_mode=mode, denoise_method=method)
    want = jec.corrected_matmul(*map(jnp.asarray, (x, w, xt, wt)), **kw)
    got = corrected_matmul(*map(torch.from_numpy, (x, w, xt, wt)), **kw)
    assert tuple(got.shape) == tuple(want.shape) == shape_x[:-1] + (40,)
    assert rel(got, want) <= TOL


def test_fused_equals_faithful_and_beats_raw():
    """Both tier-1 forms are one function; with EC the error against the
    digital product is well under the raw ``x~ @ W~``'s."""
    x, w, xt, wt = (torch.from_numpy(v) for v in operands((8, 64), (64, 32),
                                                          95))
    kw = dict(lam=1e-12)
    fused = corrected_matmul(x, w, xt, wt, ec_mode="fused", **kw)
    faithful = corrected_matmul(x, w, xt, wt, ec_mode="faithful", **kw)
    assert rel(fused, faithful) <= TOL
    digital = x @ w
    assert rel(fused, digital) < 0.2 * rel(xt @ wt, digital)


def test_unknown_modes_raise():
    x, w, xt, wt = (torch.from_numpy(v) for v in operands((4, 8), (8, 6), 97))
    with pytest.raises(ValueError, match="first-order EC mode"):
        corrected_matmul(x, w, xt, wt, ec_mode="bogus")
    with pytest.raises(ValueError, match="first-order EC mode"):
        corrected_matvecmul(w.T, x.T, wt.T, xt.T, ec_mode="bogus")
    with pytest.raises(ValueError, match="denoise method"):
        corrected_matmul(x, w, xt, wt, denoise_method="bogus")
