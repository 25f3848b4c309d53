"""bfloat16 compute: the port's analog ``dense`` and ``expert_mm`` held to the
JAX package's ``dense`` / ``_expert_mm`` at a bound derived from bfloat16's
unit roundoff, with the reference's DAC draws injected (drawn in bfloat16,
as the reference draws them).

The two packages round in different places on purpose.  The reference sums
its tier-1 product in the compute dtype, ``x @ w_tilde.astype(cd) + xt @
dw.astype(cd)`` (``src/repro/models/common.py:112``, ``moe.py:85-88``): a
bfloat16 rounding after each product and one after their sum, then the
tier-2 stencil in float32 and a last rounding to bfloat16.  The port hands
the bfloat16 operands to its float32 kernels (``ec_rmatmul`` /
``ec_group_rmatmul``, ``stencil_denoise``) and rounds once, at the end.
The port is the closer of the two to a float32 pipeline, which each test
also asserts.

The bound.  Write u = 2**-8 for bfloat16's unit roundoff (8 significand
bits, round to nearest), gamma = d_in * 2**-24 for a float32 dot product of
length d_in, and take a = x w_tilde, b = x_t dw and s = a + b in exact
arithmetic from the bfloat16 operands, A = |x| |w_tilde| + |x_t| |dw|.  To
first order in u, elementwise,

    reference:  s_r = s + a d1 + b d2 + s d3 + e_r,   |d_i| <= u,
    port:       s_p = s + e_p,     |e_r|, |e_p| <= gamma A (+ 2**-24 |s|),

and each output is S s_. rounded once more to bfloat16 (relative error <=
u), S = I - lam L^T L along the output axis, ||S|| <= 1 + 4 lam and
sigma_min(S) >= 1 - 4 lam (||L^T L|| <= (1 + |h|)^2 = 4 at h = -1).  So

    ||y_p - y_r|| <= (1 + 4 lam) (u (||a|| + ||b|| + ||s||) + 2 gamma ||A||)
                     + 2 u (1 + 4 lam) ||s||,
    ||y_r||       >= (1 - 4 lam) ||s|| (1 - O(u)),

    rel-L2(y_p, y_r) <= (1 + 4 lam) / (1 - 4 lam)
                        * ((kappa + 3) u + 2 gamma ||A|| / ||s||) * (1 + 4 u)

with kappa = (||a|| + ||b||) / ||s|| (about 1.05 here: dw is a few per cent
of w_tilde) and the factor (1 + 4 u) covering the second-order terms.  The
float32 stencil's own rounding (a few 2**-24) is inside that factor.  At
these operands the bound is 4.1 u - 4.7 u (1.6e-2 - 1.8e-2); the packages
measure 0.7 u - 0.9 u apart.  An error of another kind does not fit under it:
dropping ``dw`` from the sum moves the output by ||b|| / ||s||, about
13 u, and skipping the stencil at lam = 1e-2 by lam ||L^T L s|| / ||s||,
about 6 u (the negative cases below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import DacDraws, few_threads, rel, rng_array  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.configs.base import RRAMBackendConfig as JRRAM
from repro.models import common as jc
from repro.models import moe as jmoe
from repro_torch import kernels
from repro_torch.configs.base import RRAMBackendConfig
from repro_torch.models import common as pc
from repro_torch.models import moe as pmoe

U = 2.0 ** -8           # bfloat16's unit roundoff
F32_EPS = 2.0 ** -24    # float32's
JKEY, PKEY = jax.random.PRNGKey(5), 5
DENSE_SHAPES = [(64, 48), (512, 256)]
LAMS = [1e-12, 1e-2]


def bf16(a):
    """float32 numpy -> (jax bfloat16, torch bfloat16, float64 of it)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    f = np.array(j.astype(jnp.float32))
    return j, torch.from_numpy(f).to(torch.bfloat16), f.astype(np.float64)


def tier2(s, lam, h=-1.0):
    """``s - lam (L^T L) s`` along the last axis in float64."""
    up = np.concatenate([s[..., 1:], np.zeros_like(s[..., :1])], axis=-1)
    dn = np.concatenate([np.zeros_like(s[..., :1]), s[..., :-1]], axis=-1)
    kp = (1.0 + h * h) * s + h * (up + dn)
    kp[..., 0] -= h * h * s[..., 0]
    return s - lam * kp


def bound(a, b, absprod, d_in, lam):
    """The module docstring's bound on rel-L2(port, reference)."""
    s = a + b
    ns = np.linalg.norm(s)
    kappa = (np.linalg.norm(a) + np.linalg.norm(b)) / ns
    gamma = d_in * F32_EPS
    return ((1 + 4 * lam) / (1 - 4 * lam)
            * ((kappa + 3) * U + 2 * gamma * np.linalg.norm(absprod) / ns)
            * (1 + 4 * U))


def backend(dac, lam):
    kw = {"enabled": True, "cell_rows": 32, "cell_cols": 32,
          "dw_dtype": "bfloat16", "encode_inputs": dac, "lam": lam}
    return JRRAM(**kw), RRAMBackendConfig(**kw)


def operands(w_shape, x_shape, seed):
    """An analog layer in bfloat16 (w_tilde = w (1 + 0.05 eps), dw = w -
    w_tilde rounded) and an input, each as (jax, torch, float64); and the
    float32 weight and input they were rounded from."""
    w = rng_array(w_shape, seed, scale=w_shape[-2] ** -0.5)
    wt = (w * (1 + 0.05 * rng_array(w_shape, seed + 1))).astype(np.float32)
    jw, tw, _ = bf16(w)
    jwt, twt, fwt = bf16(wt)
    jdw, tdw, fdw = bf16(np.asarray(jw.astype(jnp.float32))
                         - np.asarray(jwt.astype(jnp.float32)))
    x = rng_array(x_shape, seed + 2)
    jx, tx, fx = bf16(x)
    return ({"w": jw, "w_tilde": jwt, "dw": jdw},
            {"w": tw, "w_tilde": twt, "dw": tdw}, (fwt, fdw),
            (jx, tx, fx), (w.astype(np.float64), x.astype(np.float64)))


def x_tilde(jx, jr):
    """The reference's DAC-encoded input of the call keyed salt 1, float64
    (the input itself with the DAC off)."""
    if not jr.encode_inputs:
        return np.asarray(jx.astype(jnp.float32)).astype(np.float64)
    return np.asarray(jc._encode_act(jx, jax.random.fold_in(JKEY, 1), jr)
                      .astype(jnp.float32)).astype(np.float64)


def runtimes(jr, pr):
    return (jc.Runtime(rram=jr, key=JKEY),
            pc.Runtime(rram=pr, key=PKEY,
                       draw=DacDraws(JKEY, PKEY, dtype=jnp.bfloat16)))


def dense_case(d_in, d_out, dac, lam):
    """(port output, reference output, bound, port and reference distance
    from the float32 pipeline) of one bfloat16 ``dense`` call on 32 rows."""
    jp, p, (fwt, fdw), (jx, tx, fx), (w32, x32) = operands(
        (d_in, d_out), (4, 8, d_in), 60 + d_in)
    jr, pr = backend(dac, lam)
    jrt, rt = runtimes(jr, pr)
    want = jc.dense(jp, jx, jrt)
    got = pc.dense(p, tx, rt)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape == (4, 8, d_out)
    xt = x_tilde(jx, jr)
    a, b = fx @ fwt, xt @ fdw
    lim = bound(a, b, np.abs(fx) @ np.abs(fwt) + np.abs(xt) @ np.abs(fdw),
                d_in, lam)
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    target = tier2(x32 @ w32, lam)
    return got, want, lim, rel(got, target), rel(want, target)


def expert_case(dac, lam, stack="wg"):
    """The same for ``expert_mm`` on one (E, D, F) expert stack of the
    reduced Mixtral-8x7B (or its (E, F, D) down stack), 12 capacity
    slots an expert."""
    cfg = jget_arch("mixtral-8x7b").reduced()
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    shape = (e, d, f) if stack == "wg" else (e, f, d)
    jp, p, (fwt, fdw), (jx, tx, fx), (w32, x32) = operands(
        shape, (e, 12, shape[1]), 70)
    jr, pr = backend(dac, lam)
    jrt, rt = runtimes(jr, pr)
    want = jmoe._expert_mm(jp, jx, jrt)
    got = pmoe.expert_mm(p, tx, rt)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape == (e, 12, shape[2])
    xt = x_tilde(jx, jr)
    mm = lambda u, v: np.einsum("ecd,edf->ecf", u, v)  # noqa: E731
    a, b = mm(fx, fwt), mm(xt, fdw)
    lim = bound(a, b, mm(np.abs(fx), np.abs(fwt)) + mm(np.abs(xt),
                                                       np.abs(fdw)),
                shape[1], lam)
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    target = tier2(mm(x32, w32), lam)
    return got, want, lim, rel(got, target), rel(want, target)


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("dac", [False, True], ids=["dac_off", "dac_on"])
@pytest.mark.parametrize("d_in,d_out", DENSE_SHAPES)
def test_dense_bf16_within_the_roundoff_bound(d_in, d_out, dac, lam):
    """bfloat16 ``dense``: the port within the derived bound of the
    reference, and no further than the reference from the float32
    pipeline (``S (x @ w)`` from the float32 operands before rounding)."""
    got, want, lim, port_err, ref_err = dense_case(d_in, d_out, dac, lam)
    err = rel(got, want)
    print(f"dense {d_in}x{d_out} dac {dac} lam {lam:g}: port vs reference "
          f"{err:.3e} ({err / U:.2f} u) <= bound {lim:.3e} "
          f"({lim / U:.2f} u); from float32: port {port_err:.3e}, "
          f"reference {ref_err:.3e}")
    assert err <= lim
    assert port_err <= ref_err


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("dac", [False, True], ids=["dac_off", "dac_on"])
@pytest.mark.parametrize("stack", ["wg", "wd"])
def test_expert_mm_bf16_within_the_roundoff_bound(stack, dac, lam):
    """bfloat16 ``expert_mm`` on a reduced Mixtral expert stack, held as
    ``dense`` is."""
    got, want, lim, port_err, ref_err = expert_case(dac, lam, stack)
    err = rel(got, want)
    print(f"expert_mm {stack} dac {dac} lam {lam:g}: port vs reference "
          f"{err:.3e} ({err / U:.2f} u) <= bound {lim:.3e} "
          f"({lim / U:.2f} u); from float32: port {port_err:.3e}, "
          f"reference {ref_err:.3e}")
    assert err <= lim
    assert port_err <= ref_err


def _drop_dw(w_tilde, dw, u, u_t):
    return kernels.ec_rmatmul_plain(w_tilde, torch.zeros_like(dw), u, u_t)


def _drop_group_dw(w_tilde, dw, u, u_t):
    return kernels.ec_group_rmatmul_plain(w_tilde, torch.zeros_like(dw), u,
                                          u_t)


def _skip_stencil(p, lam, h=-1.0):
    return p


@pytest.mark.parametrize("fault", [
    ("dense", "ec_rmatmul", _drop_dw, 1e-12),
    ("dense", "stencil_denoise", _skip_stencil, 1e-2),
    ("expert_mm", "ec_group_rmatmul", _drop_group_dw, 1e-12),
    ("expert_mm", "stencil_denoise", _skip_stencil, 1e-2),
], ids=["dense_dw_dropped", "dense_stencil_skipped",
        "expert_mm_dw_dropped", "expert_mm_stencil_skipped"])
def test_bf16_bound_rejects_another_kind_of_error(fault, monkeypatch):
    """The bound is tight enough to catch a wrong sum: with ``dw`` dropped
    from the tier-1 product, or the tier-2 stencil skipped (at lam 1e-2,
    where it moves the output), the port falls outside it (DAC on)."""
    which, name, broken, lam = fault
    monkeypatch.setattr(kernels, name, broken)
    got, want, lim, _, _ = (dense_case(512, 256, True, lam)
                            if which == "dense" else expert_case(True, lam))
    err = rel(got, want)
    print(f"{which} with {name} broken, lam {lam:g}: {err:.3e} "
          f"({err / U:.2f} u) against the bound {lim:.3e} ({lim / U:.2f} u)")
    assert err > lim
