"""The port's core foundations held to the JAX package: the implicit banded
producer of the paper's strong-scaling matrices (blocks, ground-truth
``matvec`` / ``rmatvec``, and the streamed engine driven by it), the MCA
chunkings, the drift factor and the closed-loop write-and-verify loops
(with the reference's split-key draws injected)."""
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
from repro.core import matrices as jmat
from repro.core import virtualization as jvirt
from repro.core import write_verify as jwv
from repro.engine import AnalogEngine as JaxEngine
from repro_torch.core import devices as tdev
from repro_torch.core import matrices as tmat
from repro_torch.core import virtualization as tvirt
from repro_torch.core import write_verify as twv
from repro_torch.engine import AnalogEngine
from repro_torch.interop import config_from_dict

N, CAP, SEED = 300, 64, 3        # a 5 x 5 block grid with a ragged edge


def texture(seed, i, j, cap_m=CAP, cap_n=CAP):
    """The reference's texture draw of block (i, j)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), i),
                             j)
    return np.array(jax.random.normal(key, (cap_m, cap_n), jnp.float32))


@dataclasses.dataclass(frozen=True)
class InjectedBanded(tmat.ImplicitBandedMatrix):
    """The port's producer with the reference's texture injected."""

    def block(self, i, j, *, eta=None):
        if eta is None:
            eta = torch.from_numpy(texture(self.seed, int(i), int(j),
                                           self.cap_m, self.cap_n))
        return super().block(i, j, eta=eta)


def matrices(bandwidth=8, cap_m=CAP, cap_n=CAP):
    kw = dict(n=N, cap_m=cap_m, cap_n=cap_n, seed=SEED, bandwidth=bandwidth)
    return jmat.ImplicitBandedMatrix(**kw), InjectedBanded(**kw, device="cpu")


@pytest.mark.parametrize("bandwidth", [8, 40])
def test_implicit_blocks_match_reference(bandwidth):
    """Every block of the 5 x 5 grid (diagonal, band-crossing, far from the
    band, and the zero-padded edge) equals the reference's within 1e-6
    max-abs under the reference's texture; at bandwidth 40 the texture
    reaches 120 from the diagonal, across two block boundaries."""
    jimp, timp = matrices(bandwidth)
    for i in range(5):
        for j in range(5):
            got = timp.block(i, j)
            assert got.dtype == torch.float32 and got.shape == (CAP, CAP)
            want = np.asarray(jimp.block(i, j))
            assert float(np.abs(to_np(got) - want).max()) <= 1e-6, (i, j)


def test_implicit_block_own_draws():
    """Without injected draws: deterministic in (seed, i, j), zero beyond
    three bandwidths of the diagonal and outside (n, n), the band and the
    diagonal as the formula gives them, and the texture's scale 0.05."""
    imp = tmat.ImplicitBandedMatrix(n=N, cap_m=CAP, cap_n=CAP, seed=SEED,
                                    device="cpu")
    b = imp.block(1, 1)
    assert torch.equal(b, imp.block(1, 1))
    assert not torch.equal(b, tmat.ImplicitBandedMatrix(
        n=N, cap_m=CAP, cap_n=CAP, seed=SEED + 1, device="cpu").block(1, 1))
    assert float(imp.block(0, 3).abs().max()) == 0.0
    edge = imp.block(4, 4)
    assert float(edge[N - 256:].abs().max()) == 0.0
    assert float(edge[:, N - 256:].abs().max()) == 0.0
    r = torch.arange(CAP)
    dist = (r[:, None] - r[None, :]).abs()
    band = torch.where(dist <= 8, 1.0 / (1.0 + dist.float()), 0.0)
    band += 4.0 * torch.eye(CAP)
    texture_part = (b - band)[(dist <= 24) & (dist > 0)]
    assert 0.03 < float(texture_part.std()) < 0.07
    assert float((b - band)[dist > 24].abs().max()) == 0.0


def test_implicit_matvec_oracles_match_reference():
    jimp, timp = matrices()
    x = rng_array((N,), 90)
    assert rel(timp.matvec(x), jimp.matvec(jnp.asarray(x))) <= 1e-6
    assert rel(timp.rmatvec(x), jimp.rmatvec(jnp.asarray(x))) <= 1e-6
    dense = np.block([[np.asarray(jimp.block(i, j)) for j in range(5)]
                      for i in range(5)])[:N, :N]
    assert rel(timp.matvec(x), dense @ x) <= 1e-6
    assert rel(timp.rmatvec(x), dense.T @ x) <= 1e-6


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_streamed_engine_on_the_implicit_matrix(backend):
    """The slice as a whole: the implicit producer programmed by the
    streamed engine and executed in both directions, against the JAX
    streamed engine on the reference's producer, with the reference's
    texture, programming and per-block DAC draws injected."""
    cfg = jcb.CrossbarConfig(device=jdev.get_device("taox-hfox"),
                             geom=jvirt.MCAGeometry(2, 2, 32, 32))
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    jimp, timp = matrices()
    key = jax.random.PRNGKey(17)
    jeng = JaxEngine(cfg, execution="streamed",
                     backend="pallas" if backend == "cuda" else "reference")
    ja = jeng.program(jimp.block, key, shape=(N, N))
    eng = AnalogEngine(pcfg, execution="streamed", backend=backend,
                       device="cpu")
    A = eng.program(timp.block, 0, shape=(N, N),
                    eta=torch.from_numpy(program_eta(key, cfg, 5, 5)))
    assert rel(A.at_blocks, ja.at_blocks) <= 1e-5
    x = rng_array((N, 2), 91)
    want = ja @ jnp.asarray(x)
    got = eng.mvm(A, x, eta=torch.from_numpy(block_dac_eta(key, cfg, 5, 5,
                                                           2)))
    assert rel(got, want) <= 1e-5
    want = jeng.rmvm(ja, jnp.asarray(x), key=key)
    got = eng.rmvm(A, x, eta=torch.from_numpy(
        block_dac_eta(key, cfg, 5, 5, 2, transpose=True)))
    assert rel(got, want) <= 1e-5
    # And the corrected products are close to the oracles'.
    assert rel(eng.mvm(A, x[:, 0]), timp.matvec(x[:, 0])) < 0.1
    assert rel(eng.rmvm(A, x[:, 0]), timp.rmatvec(x[:, 0])) < 0.1


def test_paper_matrix_names_the_producer():
    with pytest.raises(ValueError, match="ImplicitBandedMatrix"):
        tmat.paper_matrix("dubcova2")
    np.testing.assert_array_equal(tmat.paper_matrix("bcsstk02"),
                                  jmat.paper_matrix("bcsstk02"))


@pytest.mark.parametrize("shape", [(300, 260), (64, 64), (1, 130)])
def test_chunks_match_reference(shape):
    geom = jvirt.MCAGeometry(2, 2, 32, 32)
    pgeom = tvirt.MCAGeometry(2, 2, 32, 32)
    a = rng_array(shape, 92)
    want = np.asarray(jvirt.generate_mat_chunks(jnp.asarray(a), geom))
    got = tvirt.generate_mat_chunks(torch.from_numpy(a), pgeom)
    assert got.shape == want.shape
    np.testing.assert_array_equal(to_np(got), want)
    x = a[0]
    want = np.asarray(jvirt.generate_vec_chunks(jnp.asarray(x), geom))
    got = tvirt.generate_vec_chunks(torch.from_numpy(x), pgeom)
    np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("name", sorted(jdev.DEVICES))
def test_drift_factor_matches_reference(name):
    jd, td = jdev.get_device(name), tdev.get_device(name)
    t = np.array([0.0, 0.5, 1.0, 3600.0, 3.15e7], np.float32)
    got = tdev.drift_factor(td, torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(jdev.drift_factor(jd, t)),
                               rtol=1e-6)
    assert float(tdev.drift_factor(td, 0.0)) == 1.0
    for s in (0.0, 10.0, 86400.0):
        assert tdev.drift_factor_py(td, s) == jdev.drift_factor_py(jd, s)


def ref_pass_draws(key, shape, max_iters):
    """The reference loop's per-pass draws: pass k normal(split(key_k)[1]),
    key_{k+1} = split(key_k)[0]."""
    out = []
    for _ in range(max_iters + 1):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


WV_CASES = {
    "mat-taox-l2": ("mat", "taox-hfox", dict(eps=0.3, p=2), (48, 40)),
    "mat-epiram-inf": ("mat", "epiram", dict(eps=0.02, p=np.inf), (32, 32)),
    "mat-epiram-cap": ("mat", "epiram", dict(eps=1e-3, max_iters=6), (16, 24)),
    "vec-agsi": ("vec", "ag-si", dict(eps=0.2), (100,)),
    "refresh-taox": ("refresh", "taox-hfox", dict(k_iters=5), (64, 64)),
}


@pytest.mark.parametrize("case", list(WV_CASES))
def test_write_and_verify_matches_reference(case):
    """The host loop against the reference's ``while_loop`` under the
    reference's per-pass draws: the same iteration count, the image within
    1e-6 and the write stats within 1e-6 relative."""
    form, name, kw, shape = WV_CASES[case]
    a = rng_array(shape, 93)
    key = jax.random.PRNGKey(31)
    jd, td = jdev.get_device(name), tdev.get_device(name)
    jrun = {"mat": jwv.adjustable_mat_write_and_verify,
            "vec": jwv.adjustable_vec_write_and_verify,
            "refresh": jwv.refresh_write_and_verify}[form]
    trun = {"mat": twv.adjustable_mat_write_and_verify,
            "vec": twv.adjustable_vec_write_and_verify,
            "refresh": twv.refresh_write_and_verify}[form]
    want_at, want = jrun(jnp.asarray(a), key, jd, **kw)
    passes = kw.get("k_iters", kw.get("max_iters", 20))
    eta = torch.from_numpy(ref_pass_draws(key, shape, passes))
    got_at, got = trun(torch.from_numpy(a), 0, td, eta=eta, **kw)
    assert got.iterations == int(want.iterations)
    assert float(np.abs(to_np(got_at) - np.asarray(want_at)).max()) <= 1e-6
    for field in ("energy_j", "latency_s", "final_delta"):
        assert getattr(got, field) == pytest.approx(
            float(getattr(want, field)), rel=1e-6), field


def test_write_and_verify_own_draws_and_errors():
    """The port's own draws: deterministic per key, the stopping rule held
    (below eps, or at the cap), more passes for a tighter eps; the
    matrix and vector forms refuse the other rank; a wrong eta shape is
    refused."""
    td = tdev.get_device("taox-hfox")
    a = torch.from_numpy(rng_array((40, 40), 94))
    at, st = twv.adjustable_write_and_verify(a, 5, td, eps=0.3)
    again, st2 = twv.adjustable_write_and_verify(a, 5, td, eps=0.3)
    assert torch.equal(at, again) and st == st2
    assert st.final_delta <= 0.3 or st.iterations == 20
    _, tight = twv.adjustable_write_and_verify(a, 5, td, eps=0.05)
    assert tight.iterations >= st.iterations
    assert tight.energy_j == pytest.approx(
        (tight.iterations + 1) * a.numel() * td.e_write, rel=1e-6)
    with pytest.raises(ValueError):
        twv.adjustable_mat_write_and_verify(a[0], 5, td)
    with pytest.raises(ValueError):
        twv.adjustable_vec_write_and_verify(a, 5, td)
    with pytest.raises(ValueError, match="eta"):
        twv.adjustable_write_and_verify(a, 5, td, max_iters=3,
                                        eta=torch.zeros(3, 40, 40))


@pytest.mark.parametrize("form", ["any", "mat", "vec", "refresh"])
def test_write_and_verify_refuses_host_arrays(form):
    """The loop runs on its input's device, so a numpy array (which has
    none) is refused rather than run on the CPU by default; the same
    values as a tensor program on that tensor's device."""
    td = tdev.get_device("taox-hfox")
    a = rng_array((12,) if form == "vec" else (12, 16), 95)
    run = {"any": twv.adjustable_write_and_verify,
           "mat": twv.adjustable_mat_write_and_verify,
           "vec": twv.adjustable_vec_write_and_verify,
           "refresh": lambda a, key, d: twv.refresh_write_and_verify(
               a, key, d, k_iters=3)}[form]
    with pytest.raises(TypeError, match="torch.Tensor"):
        run(a, 5, td)
    at, stats = run(torch.from_numpy(a), 5, td)
    assert at.device.type == "cpu" and at.shape == a.shape
    assert stats.iterations >= 0
