"""The port's core modules held to the JAX package: device constants, write
cost, virtualization, metrics, matrices and error correction exactly or to
float32 rounding; the programmed image and the reference execute with the
reference's noise injected (rel-L2 <= 1e-5, the cross-path bound of
tests/conftest.py); and the port's own key schedule for determinism,
independence and moments."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (block_dac_eta, few_threads, program_eta,  # noqa: F401
                         rel, rng_array, to_np)
from repro.core import crossbar as jcb
from repro.core import devices as jdev
from repro.core import error_correction as jec
from repro.core import matrices as jmat
from repro.core import metrics as jmet
from repro.core import virtualization as jvirt
from repro_torch.core import crossbar as tcb
from repro_torch.core import devices as tdev
from repro_torch.core import error_correction as tec
from repro_torch.core import matrices as tmat
from repro_torch.core import metrics as tmet
from repro_torch.core import prng
from repro_torch.core import virtualization as tvirt
from repro_torch.interop import config_from_dict

TOL = 1e-5


def jax_cfg(device="taox-hfox", geom=(2, 2, 32, 32), **kw):
    return jcb.CrossbarConfig(device=jdev.get_device(device),
                              geom=jvirt.MCAGeometry(*geom), **kw)


def port_cfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


# ------------------------------------------------------------ exact twins
def test_device_constants_equal():
    assert set(tdev.DEVICES) == set(jdev.DEVICES)
    for name, dev in jdev.DEVICES.items():
        port = tdev.get_device(name.upper().replace("-", "_"))
        assert dataclasses.asdict(port) == dataclasses.asdict(dev)
        assert port.sigma_floor == dev.sigma_floor
        for k in (0, 1, 5, 12):
            assert tdev.effective_sigma_py(port, k) == \
                jdev.effective_sigma_py(dev, k)
            assert abs(float(tdev.effective_sigma(port, k))
                       - float(jdev.effective_sigma(dev, k))) <= \
                1e-7 * float(jdev.effective_sigma(dev, k))
    with pytest.raises(KeyError):
        tdev.get_device("nope")


@pytest.mark.parametrize("kw", [{}, {"skip_zero_pad_writes": True},
                                {"ec": False}, {"encode_inputs": False},
                                {"k_iters": 0}])
def test_write_cost_equal(kw):
    cfg = jax_cfg(**kw)
    pcfg = port_cfg(cfg)
    for (m, n, batch) in [(66, 66, 1), (150, 130, 3), (64, 64, 8)]:
        want = jcb.write_cost(m, n, cfg, batch)
        got = tcb.write_cost(m, n, pcfg, batch)
        assert got.energy_j == pytest.approx(float(want.energy_j), rel=1e-6)
        assert got.latency_s == pytest.approx(float(want.latency_s), rel=1e-6)
        assert got.iterations == int(want.iterations)
        assert got.final_delta == pytest.approx(float(want.final_delta),
                                                rel=1e-6)
        for jf, tf in [(jcb.matrix_write_cost(m, n, cfg),
                        tcb.matrix_write_cost(m, n, pcfg)),
                       (jcb.input_write_cost(m, n, cfg, batch),
                        tcb.input_write_cost(m, n, pcfg, batch)),
                       (jcb.tile_write_cost(cfg), tcb.tile_write_cost(pcfg))]:
            assert tf.energy_j == pytest.approx(float(jf.energy_j), rel=1e-6)
            assert tf.latency_s == pytest.approx(float(jf.latency_s), rel=1e-6)


@pytest.mark.parametrize("kw", [{}, {"skip_zero_pad_writes": True},
                                {"ec": False}, {"encode_inputs": False}])
def test_transposed_write_cost_equal(kw):
    """``transpose=True`` bills the row-dimension input pass; on a non-square
    geometry (cells 16 x 8, a 2 x 3 tile) it differs from the forward bill,
    and both equal the reference exactly (the reference stores float32, so
    the port's float is compared rounded to float32)."""
    cfg = jax_cfg(geom=(2, 3, 16, 8), **kw)
    pcfg = port_cfg(cfg)
    for (m, n, batch) in [(66, 66, 1), (150, 40, 3), (20, 100, 8)]:
        for fn, args in [(tcb.write_cost, (m, n, pcfg, batch)),
                         (tcb.input_write_cost, (m, n, pcfg, batch))]:
            jfn = getattr(jcb, fn.__name__)
            got = fn(*args, transpose=True)
            want = jfn(m, n, cfg, batch, transpose=True)
            assert np.float32(got.energy_j) == want.energy_j
            assert np.float32(got.latency_s) == want.latency_s
    fwd = tcb.input_write_cost(150, 40, pcfg, 2)
    tra = tcb.input_write_cost(150, 40, pcfg, 2, transpose=True)
    if pcfg.ec or pcfg.encode_inputs:
        assert tra.energy_j != fwd.energy_j


def test_virtualization_equal():
    geom = (2, 3, 16, 8)
    jg, tg = jvirt.MCAGeometry(*geom), tvirt.MCAGeometry(*geom)
    assert tg.capacity == jg.capacity and tg.n_mcas == jg.n_mcas
    assert tg.cells_per_mca == jg.cells_per_mca
    a = rng_array((70, 50), 0)
    np.testing.assert_array_equal(
        to_np(tvirt.block_partition(torch.from_numpy(a), tg)),
        np.asarray(jvirt.block_partition(jnp.asarray(a), jg)))
    v = rng_array((50,), 1)
    np.testing.assert_array_equal(
        to_np(tvirt.zero_padding(torch.from_numpy(v), tg)),
        np.asarray(jvirt.zero_padding(jnp.asarray(v), jg)))
    y = rng_array((3, 32), 2)
    np.testing.assert_array_equal(
        to_np(tvirt.reassemble(torch.from_numpy(y), 70)),
        np.asarray(jvirt.reassemble(jnp.asarray(y), 70)))
    assert tvirt.reassignment_count(70, 50, tg) == \
        jvirt.reassignment_count(70, 50, jg)


def test_metrics_and_matrices_equal():
    y, b = rng_array((40, 3), 3), rng_array((40, 3), 4)
    for t, j in [(tmet.rel_l2, jmet.rel_l2), (tmet.rel_linf, jmet.rel_linf)]:
        assert float(t(torch.from_numpy(y), torch.from_numpy(b))) == \
            pytest.approx(float(j(jnp.asarray(y), jnp.asarray(b))), rel=1e-6)
    for name in ("bcsstk02", "iperturb"):
        np.testing.assert_array_equal(tmat.paper_matrix(name),
                                      jmat.paper_matrix(name))
    np.testing.assert_array_equal(tmat.make_spd_with_condition(20, 50.0, 3),
                                  jmat.make_spd_with_condition(20, 50.0, 3))


@pytest.mark.parametrize("axis", [None, (1, 3)])
def test_quantize_equal(axis):
    w = rng_array((3, 8, 2, 8), 5)
    w[1] = 0.0                          # an all-zero tile keeps scale 1
    np.testing.assert_array_equal(
        to_np(tdev.quantize(torch.from_numpy(w), 8, axis=axis)),
        np.asarray(jdev.quantize(jnp.asarray(w), 8, axis=axis)))


# ------------------------------------------------------- error correction
@pytest.mark.parametrize("method", ["dense", "thomas", "neumann"])
@pytest.mark.parametrize("lam", [1e-12, 1e-2])
def test_denoise_least_square_matches(method, lam):
    p = rng_array((48, 4), 6)
    want = jec.denoise_least_square(jnp.asarray(p), lam=lam, method=method)
    got = tec.denoise_least_square(torch.from_numpy(p), lam=lam,
                                   method=method)
    assert rel(got, want) <= TOL
    with pytest.raises(ValueError):
        tec.denoise_least_square(torch.from_numpy(p), method="nope")


@pytest.mark.parametrize("mode", ["fused", "faithful"])
def test_first_order_correct_matches(mode):
    a, x = rng_array((30, 20), 7), rng_array((20, 2), 8)
    at = a * (1 + 0.1 * rng_array((30, 20), 9))
    xt = x * (1 + 0.1 * rng_array((20, 2), 10))
    want = jec.first_order_correct(*(jnp.asarray(v) for v in (a, at, x, xt)),
                                   mode=mode)
    got = tec.first_order_correct(*(torch.from_numpy(v)
                                    for v in (a, at, x, xt)), mode=mode)
    assert rel(got, want) <= TOL
    for t, j in zip(tec.tridiag_coeffs(9, 0.3), jec.tridiag_coeffs(9, 0.3)):
        np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-7)


# ------------------------------------------- noisy stages, noise injected
def test_encode_tiled_matches_with_injected_eta():
    cfg = jax_cfg()
    a = rng_array((64, 96), 11)
    key = jax.random.PRNGKey(3)
    want = jcb.encode_tiled(jnp.asarray(a), key, cfg)
    eta = jax.random.normal(key, (2, 32, 3, 32), dtype=jnp.float32)
    got = tcb.encode_tiled(torch.from_numpy(a), port_cfg(cfg),
                           eta=torch.from_numpy(np.array(eta)))
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("axis", [None, 1])
def test_encode_matches_with_injected_eta(axis):
    dev = jdev.get_device("alox-hfo2")
    w = rng_array((40, 24), 16)
    key = jax.random.PRNGKey(8)
    want = jdev.encode(jnp.asarray(w), key, dev, k_iters=2,
                       quantize_axis=axis)
    eta = np.array(jax.random.normal(key, w.shape, dtype=jnp.float32))
    got = tdev.encode(torch.from_numpy(w), tdev.get_device("alox-hfo2"),
                      k_iters=2, quantize_axis=axis, eta=torch.from_numpy(eta))
    assert rel(got, want) <= TOL
    with pytest.raises(ValueError):
        tdev.encode(torch.from_numpy(w), tdev.get_device("alox-hfo2"))


@pytest.mark.parametrize("shape,geom", [((66, 66), (1, 1, 66, 66)),
                                        ((150, 130), (2, 2, 32, 32))])
def test_program_blocks_matches_with_injected_eta(shape, geom):
    cfg = jax_cfg(geom=geom)
    a = rng_array(shape, 12)
    key = jax.random.PRNGKey(7)
    at_j, da_j = jcb.program_blocks(jnp.asarray(a), key, cfg)
    mb, nb = at_j.shape[:2]
    eta = torch.from_numpy(program_eta(key, cfg, mb, nb))
    at, da = tcb.program_blocks(torch.from_numpy(a), 0, port_cfg(cfg), eta=eta)
    pg = port_cfg(cfg).geom
    assert rel(tvirt.blocks_view(at, pg), at_j) <= TOL
    assert rel(tvirt.blocks_view(da, pg), da_j) <= TOL
    # The image is dense padded, A_tilde + dA reproduces A.
    assert at.shape == (mb * pg.capacity[0], nb * pg.capacity[1])
    assert rel(tcb.assemble_blocks(at + da, *shape), a) <= 1e-6


@pytest.mark.parametrize("kw", [{}, {"ec_mode": "faithful"}, {"ec": False},
                                {"encode_inputs": False},
                                {"denoise_method": "thomas", "lam": 1e-2}])
def test_programmed_block_mvm_matches_with_injected_eta(kw):
    cfg = jax_cfg(**kw)
    pcfg = port_cfg(cfg)
    m, n, batch = 150, 130, 3
    a, x = rng_array((m, n), 13), rng_array((n, batch), 14)
    key, xkey = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    at_j, da_j = jcb.program_blocks(jnp.asarray(a), key, cfg)
    mb, nb = at_j.shape[:2]
    at, da = tcb.program_blocks(
        torch.from_numpy(a), 0, pcfg,
        eta=torch.from_numpy(program_eta(key, cfg, mb, nb)))
    dac = torch.from_numpy(block_dac_eta(xkey, cfg, mb, nb, batch))
    for tier2 in (True, False):
        want = jcb.programmed_block_mvm(at_j, da_j, jnp.asarray(x), xkey, cfg,
                                        m=m, n=n, tier2=tier2)
        got = tcb.programmed_block_mvm(at, da, torch.from_numpy(x), 0, pcfg,
                                       m=m, n=n, tier2=tier2, eta=dac)
        assert got.shape == (m, batch)
        assert rel(got, want) <= TOL


@pytest.mark.parametrize("kw", [{}, {"ec_mode": "faithful"}, {"ec": False},
                                {"encode_inputs": False},
                                {"denoise_method": "thomas", "lam": 1e-2}])
@pytest.mark.parametrize("shape,geom", [((66, 66), (1, 1, 66, 66)),
                                        ((150, 70), (2, 2, 32, 16))])
def test_programmed_block_rmvm_matches_with_injected_eta(kw, shape, geom):
    """A.T @ y against the programmed image: the 66 x 66 paper matrix
    (bcsstk02) on one block and a non-divisible rectangular shape over 3 x 3
    non-square blocks, with the reference's row-chunk DAC draws (the k_x
    half of each block key, as forward) injected; tier2 on and off."""
    cfg = jax_cfg(geom=geom, **kw)
    pcfg = port_cfg(cfg)
    m, n = shape
    a = tmat.paper_matrix("bcsstk02") if shape == (66, 66) \
        else rng_array(shape, 17)
    a = np.asarray(a, np.float32)
    y = rng_array((m, 2), 18)
    key, ykey = jax.random.PRNGKey(9), jax.random.PRNGKey(10)
    at_j, da_j = jcb.program_blocks(jnp.asarray(a), key, cfg)
    mb, nb = at_j.shape[:2]
    at, da = tcb.program_blocks(
        torch.from_numpy(a), 0, pcfg,
        eta=torch.from_numpy(program_eta(key, cfg, mb, nb)))
    dac = torch.from_numpy(block_dac_eta(ykey, cfg, mb, nb, 2,
                                         transpose=True))
    for tier2 in (True, False):
        want = jcb.programmed_block_rmvm(at_j, da_j, jnp.asarray(y), ykey,
                                         cfg, m=m, n=n, tier2=tier2)
        got = tcb.programmed_block_rmvm(at, da, torch.from_numpy(y), 0, pcfg,
                                        m=m, n=n, tier2=tier2, eta=dac)
        assert got.shape == (n, 2)
        assert rel(got, want) <= TOL


@pytest.mark.parametrize("transpose", [False, True])
def test_block_execute_use_kernel_matches(transpose):
    """``use_kernel=True``: each block's tier-1 product through the fused
    kernel on the block view (its plain version here), held to the JAX
    stage with its Pallas tile step (interpret mode)."""
    cfg = jax_cfg(geom=(2, 2, 16, 16))
    pcfg = port_cfg(cfg)
    m, n = 70, 40
    a = rng_array((m, n), 19)
    u = rng_array((n if not transpose else m, 3), 20)
    key, ukey = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    at_j, da_j = jcb.program_blocks(jnp.asarray(a), key, cfg)
    mb, nb = at_j.shape[:2]
    at, da = tcb.program_blocks(
        torch.from_numpy(a), 0, pcfg,
        eta=torch.from_numpy(program_eta(key, cfg, mb, nb)))
    dac = torch.from_numpy(block_dac_eta(ukey, cfg, mb, nb, 3,
                                         transpose=transpose))
    jrun = jcb.programmed_block_rmvm if transpose else jcb.programmed_block_mvm
    trun = tcb.programmed_block_rmvm if transpose else tcb.programmed_block_mvm
    want = jrun(at_j, da_j, jnp.asarray(u), ukey, cfg, m=m, n=n,
                use_kernel=True)
    got = trun(at, da, torch.from_numpy(u), 0, pcfg, m=m, n=n,
               use_kernel=True, eta=dac)
    assert rel(got, want) <= TOL
    assert rel(got, trun(at, da, torch.from_numpy(u), 0, pcfg, m=m, n=n,
                         eta=dac)) <= TOL


# ----------------------------------------------------- the port's own draws
def test_key_schedule_deterministic_and_global():
    """Same key -> same image; block (I, J)'s draws depend on the global
    block index only, so a bigger matrix sharing the top-left blocks
    programs them identically."""
    cfg = port_cfg(jax_cfg())
    a = torch.from_numpy(rng_array((192, 192), 15))
    at1, _ = tcb.program_blocks(a[:128, :128], 9, cfg)
    at2, _ = tcb.program_blocks(a[:128, :128], 9, cfg)
    at3, _ = tcb.program_blocks(a, 9, cfg)
    at4, _ = tcb.program_blocks(a[:128, :128], 10, cfg)
    assert torch.equal(at1, at2)
    assert torch.equal(at1, at3[:128, :128])
    assert not torch.equal(at1, at4)
    assert prng.block_key(9, 0, 1) != prng.block_key(9, 1, 0)
    assert len({prng.fold_in(9, i) for i in range(1000)}) == 1000


def test_noise_moments():
    """The programming noise is N(0, 1) scaled by sigma_k: an encode of a
    constant matrix (which quantizes exactly) has the device's relative
    spread and no bias."""
    dev = tdev.get_device("taox-hfox")
    cfg = tcb.CrossbarConfig(device=dev, geom=tvirt.MCAGeometry(1, 1, 256, 256))
    ones = torch.ones(256, 256)
    enc = tcb.encode_tiled(ones, cfg, gen=prng.generator(3, "cpu"))
    rel_noise = enc - 1.0
    sigma = float(tdev.effective_sigma(dev, cfg.k_iters))
    assert abs(float(rel_noise.mean())) < 4 * sigma / 256
    assert float(rel_noise.std()) == pytest.approx(sigma, rel=0.02)
    x = tcb._encode_vec(torch.ones(4096, 2), cfg, gen=prng.generator(4, "cpu"))
    assert float((x - 1).std()) == pytest.approx(sigma, rel=0.05)
