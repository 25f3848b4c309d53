"""Gradients of the port held to ``jax.grad`` of the JAX package's: the loss
of each family (qwen3-1.7b, mixtral-8x7b, rwkv6-1.6b, zamba2-1.2b,
whisper-tiny, llama-3.2-vision-11b, reduced: 2 layers, d_model 64) on
every parameter leaf, with ``remat`` "none" and "block" equal bit for bit;
RoPE's VJP; the analog ``dense`` (:class:`AnalogProduct` over the
kernels' wrappers, on CPU tensors their plain versions) and the MoE's
grouped ``expert_mm``, with the reference's DAC draws injected; and the
DAC salts of an analog train step of two microbatches against the
reference's jitted step.

Inputs are made with numpy from fixed seeds.  Some gradients are ill
conditioned in float32: the reference's own rwkv6 gradient moves up to
6e-6 when its embedding moves by one ulp, and the port's, whose sums run
in another order, lies up to 2e-5 from it (``pytest -s`` prints both).
So each leaf is held to 1e-5 or to 4x the reference's own response to
that nudge, whichever is larger (the rule of
``test_torch_recurrent_depth.py``); a wrong formula moves a gradient by
far more.  The witness that this is conditioning: with every float32 of
its path made float64 in both packages, rwkv6's gradient agrees to 1e-14,
held to 1e-10.  rwkv6's random-init log-decays cross LOG_CLAMP (a sixth
of them are clamped) but none sits on a bound, where ``jnp.clip`` and
``torch.clamp`` would split the gradient differently."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (JKEY, PKEY, make_batch, np_tree,
                             reference_model, rram_cfgs, torch_batch)
from _torch_port import DacDraws, few_threads, rel, rng_array, to_np  # noqa: F401,E501
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import common as jc
from repro.models import moe as jmoe
from repro.models import rram as jrram
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch.configs import get_arch, model_module
from repro_torch.configs.base import TrainConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import common as pc
from repro_torch.models import moe as pmoe
from repro_torch.models import params as pPM
from repro_torch.train import optimizer as popt
from repro_torch.train import train_loop as ptl

TOL = 1e-5              # rel-L2 of each gradient leaf against jax.grad's
NUDGE_SLACK = 4.0       # or this multiple of the reference's ulp response
TWIN_TOL = 1e-6         # AnalogProduct against plain autograd, same device
F64_TOL = 1e-10         # rel-L2 of a gradient leaf, both packages in float64
FAMILIES = ["qwen3-1.7b", "mixtral-8x7b", "rwkv6-1.6b", "zamba2-1.2b",
            "whisper-tiny", "llama-3.2-vision-11b"]
LAM = 1e-2              # the stencil term shows in float32


def nudged(tree):
    """``tree`` with its embedding moved up by one float32 ulp."""
    return dict(tree, embed=jnp.nextafter(tree["embed"], jnp.inf))


def nudge_responses(want, want_nudged):
    """Per leaf: the rel-L2 between the reference's gradient and its
    gradient at the nudged embedding."""
    return [rel(a, b) for a, b in
            zip(jax.tree.leaves(want), jax.tree.leaves(want_nudged))]


def leaf_bounds(nudges):
    """Per leaf: max(TOL, NUDGE_SLACK x its nudge response)."""
    return [max(TOL, NUDGE_SLACK * n) for n in nudges]


def port_grads(mod, p, batch, cfg, rt):
    """(loss, [gradient leaf]) of ``mod.loss`` over every leaf of ``p``,
    zeros where the loss does not reach (``jax.grad``'s)."""
    loss, grads = ptl.loss_and_grads(mod, p, batch, cfg, rt)
    return loss, [torch.zeros_like(t) if g is None else g
                  for (_, t), g in zip(pPM.tree_paths(p), grads)]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_loss_gradient_matches_jax_grad(name):
    jcfg, jmod, jparams, _ = reference_model(name)
    cfg = get_arch(name).reduced()
    mod = model_module(cfg)
    batch = make_batch(cfg, 2, 8, 70)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda prm: jmod.loss(prm, batch, jcfg, jc.Runtime())))
    jloss, jgrads = grad_fn(jparams)
    nudges = nudge_responses(jgrads, grad_fn(nudged(jparams))[1])
    bounds = leaf_bounds(nudges)
    p = params_from_numpy(np_tree(jparams), "cpu")
    runs = {remat: port_grads(mod, p, torch_batch(batch), cfg,
                              pc.Runtime(remat=remat))
            for remat in ("none", "block")}
    (loss, grads), (loss_r, grads_r) = runs["none"], runs["block"]
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))
    assert rel(loss, jloss) <= TOL
    paths = [q for q, _ in pPM.tree_paths(p)]
    want = jax.tree.leaves(jgrads)
    assert len(want) == len(grads)
    errs = []
    for path, g, w, bound in zip(paths, grads, want, bounds):
        w = np.asarray(w)
        assert np.isfinite(w).all(), path
        if not w.any():
            assert not bool(g.any()), path
            continue
        errs.append(rel(g, w))
        assert errs[-1] <= bound, (path, bound)
    # Shown with ``pytest -s``: the leaves' rel-L2 against the reference,
    # and the reference's own response to the nudge.
    print(f"{name}: gradient leaves {min(errs):.2e}-{max(errs):.2e} from "
          f"jax.grad; the reference's nudge response {min(nudges):.2e}-"
          f"{max(nudges):.2e}")


class _Wide:
    """A module's stand-in whose ``float32`` is float64 (``wide``)."""

    def __init__(self, module, wide):
        self._module, self.float32 = module, wide

    def __getattr__(self, name):
        return getattr(self._module, name)


def test_rwkv6_gradient_in_float64_matches_jax_grad(monkeypatch):
    """The witness that rwkv6's float32 distance above is conditioning, not
    a formula: both packages with every float32 of the model's path made
    float64 (the reference under ``jax.enable_x64``; its modules' ``jnp``
    and the port's ``torch`` / ``_F32`` with ``float32`` widened) give the
    same loss gradient to F64_TOL a leaf (1e-14 measured)."""
    from repro.models import linear_attention as jla
    from repro.models import rwkv6 as jrwkv6
    from repro_torch.models import linear_attention as pla
    from repro_torch.models import rwkv6 as prwkv6
    name = "rwkv6-1.6b"
    jcfg, _, jparams, _ = reference_model(name)
    wide = {"param_dtype": "float64", "compute_dtype": "float64"}
    jcfg = dataclasses.replace(jcfg, **wide)
    cfg = dataclasses.replace(get_arch(name).reduced(), **wide)
    batch = make_batch(cfg, 2, 8, 70)
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), np_tree(jparams))
    for m in (jc, jrwkv6, jla):
        monkeypatch.setattr(m, "jnp", _Wide(jnp, jnp.float64))
    monkeypatch.setattr(pc, "torch", _Wide(torch, torch.float64))
    for m in (prwkv6, pla):
        monkeypatch.setattr(m, "_F32", torch.float64)
    with jax.enable_x64(True):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda prm: jrwkv6.loss(prm, batch, jcfg, jc.Runtime())))(
                jax.tree.map(jnp.asarray, p64))
        want = [np.asarray(w) for w in jax.tree.leaves(jgrads)]
    p = params_from_numpy(p64, "cpu")
    loss, grads = port_grads(model_module(cfg), p, torch_batch(batch), cfg,
                             pc.Runtime())
    assert loss.dtype == torch.float64 and want[0].dtype == np.float64
    assert rel(loss, np.asarray(jloss)) <= F64_TOL
    assert len(want) == len(grads)
    for (path, _), g, w in zip(pPM.tree_paths(p), grads, want):
        assert g.dtype == torch.float64, path
        assert rel(g, w) <= F64_TOL, path


def test_rope_vjp_matches_the_references():
    """The port's autograd of ``rope`` is ``g cos2 + rot(g) (-sin2)``, the
    reference's custom VJP, bit for bit on the port's tables, and equals
    ``jax.vjp`` of the reference's ``rope``."""
    x = rng_array((2, 6, 3, 8), 1)
    g = rng_array((2, 6, 3, 8), 2)
    pos = np.tile(np.arange(3, 9, dtype=np.int32), (2, 1))
    _, vjp = jax.vjp(lambda a: jc.rope(a, pos, 10_000.0), x)
    (want,) = vjp(g)
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(pos)
    out = pc.rope(xt, pt, 10_000.0)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    cos2, sin2 = pc.rope_tables(pt, 10_000.0, 8)
    gt = torch.from_numpy(g)
    rot = torch.cat([gt[..., 4:], gt[..., :4]], dim=-1)
    assert torch.equal(got, gt * cos2 + rot * (-sin2))
    assert rel(got, want) <= TOL


def _dense_case(d_in, d_out, seed, dw_dtype, group=None):
    """A programmed kernel (``w_tilde`` 2 % off ``w``, ``dw`` the rest, in
    ``dw_dtype``), 2-D or a ``group``-member stack, as numpy."""
    lead = () if group is None else (group,)
    w = rng_array(lead + (d_in, d_out), seed, d_in ** -0.5)
    wt = (w * (1 + 0.02 * rng_array(w.shape, seed + 1))).astype(np.float32)
    dw = jnp.asarray(w - wt, jnp.dtype(dw_dtype))
    return {"w": w, "w_tilde": wt, "dw": np.asarray(dw)}


def _analog_runtimes():
    jr, pr = rram_cfgs(lam=LAM)
    return jc.Runtime(rram=jr, key=JKEY), pc.Runtime(
        rram=pr, key=PKEY, draw=DacDraws(JKEY, PKEY, salts=2))


@pytest.mark.parametrize("dw_dtype", ["float32", "bfloat16"])
def test_analog_dense_gradient_matches_jax_grad(dw_dtype):
    """The gradients of x, w_tilde and dw (w takes none) through the
    analog dense, on 3 x 5 rows of 48 -> 40 with the reference's draw."""
    pnp = _dense_case(48, 40, 3, dw_dtype)
    x = rng_array((3, 5, 48), 5)
    cot = rng_array((3, 5, 40), 6)
    jrt, _ = _analog_runtimes()
    jgp, jgx = jax.grad(lambda prm, a: jnp.sum(jc.dense(prm, a, jrt) * cot),
                        argnums=(0, 1))(pnp, x)
    got = {}
    for fn in (pc.dense, pc.dense_plain):
        _, rt = _analog_runtimes()
        p = params_from_numpy(pnp, "cpu")
        leaves = [p["w"], p["w_tilde"], p["dw"], torch.from_numpy(x)]
        live = [t.detach().requires_grad_() for t in leaves]
        out = fn(dict(zip(("w", "w_tilde", "dw"), live[:3])), live[3], rt)
        got[fn] = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                      live, allow_unused=True)
        assert rt.draw.calls == [(None, 1)]
    gw, gwt, gdw, gx = got[pc.dense]
    assert gw is None and gdw.dtype == pPM.torch_dtype(dw_dtype)
    assert not np.asarray(jgp["w"]).any()
    assert rel(gx, jgx) <= TOL and rel(gwt, jgp["w_tilde"]) <= TOL
    if dw_dtype == "float32":
        assert rel(gdw, jgp["dw"]) <= TOL
    else:
        # The float32 gradient rounded to bfloat16 on both sides: an
        # element on a rounding boundary may round either way (one bf16
        # ulp, 2^-8 relative), so each element is held to two ulps.
        np.testing.assert_allclose(
            to_np(gdw.float()), np.asarray(jgp["dw"], np.float32),
            rtol=2 ** -7, atol=0)
    for a, b in zip(got[pc.dense][1:], got[pc.dense_plain][1:]):
        assert rel(a.float(), b.float()) <= TWIN_TOL


def test_expert_mm_gradient_matches_jax_grad():
    """The MoE's grouped EC product (one DAC draw over the (E, C, D)
    buffer) differentiated through AnalogProduct's stacked backward."""
    pnp = _dense_case(24, 32, 7, "float32", group=3)
    x = rng_array((3, 8, 24), 8)
    cot = rng_array((3, 8, 32), 9)
    jrt, rt = _analog_runtimes()
    jgp, jgx = jax.grad(
        lambda prm, a: jnp.sum(jmoe._expert_mm(prm, a, jrt) * cot),
        argnums=(0, 1))(pnp, x)
    p = params_from_numpy(pnp, "cpu")
    live = [p["w_tilde"].requires_grad_(), p["dw"].requires_grad_(),
            torch.from_numpy(x).requires_grad_()]
    out = pmoe.expert_mm(dict(p, w_tilde=live[0], dw=live[1]), live[2], rt)
    gwt, gdw, gx = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                       live)
    assert rel(gx, jgx) <= TOL and rel(gwt, jgp["w_tilde"]) <= TOL \
        and rel(gdw, jgp["dw"]) <= TOL


def test_analog_train_step_salts_follow_the_references_trace(monkeypatch):
    """One analog train step of two microbatches on reduced qwen3-1.7b
    programmed on cells of 32^2 (dw in float32: a bfloat16 dw's gradient
    is rounded to bfloat16, whose ulp is far over the bound, and
    ``test_analog_dense_gradient_matches_jax_grad`` holds it): the reference's jitted step traces its
    DAC draws once (the layer scan's 7 salts, the head's 8th) and every
    microbatch reuses them; the port restores the salt before each
    microbatch and draws, with the reference's draws injected, the same
    keys call by call, so the loss and the gradient (through m: from a
    zero state, 0.1 x the clipped gradient) agree.
    Under remat "block" the backward recomputes each layer under its
    salts and the step is the same bit for bit."""
    jr, pr = rram_cfgs(dw_dtype="float32")
    jcfg, jmod, jparams, _ = reference_model("qwen3-1.7b")
    jprog = jax.jit(lambda prm: jrram.program_rram(
        prm, jr, jax.random.PRNGKey(7))[0])(jparams)
    cfg = get_arch("qwen3-1.7b").reduced()
    mod = model_module(cfg)
    kw = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 20, "microbatch": 2,
          "remat": "none"}
    batch = make_batch(cfg, 4, 6, 71)
    seen = []
    real = jc._encode_act
    monkeypatch.setattr(jc, "_encode_act",
                        lambda x, key, c: seen.append(x.shape) or
                        real(x, key, c))
    jstep = jax.jit(jtl.make_train_step(
        jmod, jcfg, JTrainConfig(**kw), jc.Runtime(rram=jr, key=JKEY)))
    _, jstate, jm = jstep(jprog, jopt.adamw_init(jprog), batch)
    bounds = leaf_bounds(nudge_responses(
        jstate.m, jstep(nudged(jprog), jopt.adamw_init(jprog), batch)[1].m))
    body = [(None, s) for s in range(1, 8)]    # attention 4 + mlp 3
    seq, n_salts = body * cfg.n_layers + [(None, 8)], 8
    assert len(seen) == n_salts
    out = {}
    for remat in ("none", "block"):
        p = params_from_numpy(np_tree(jprog), "cpu")
        draws = DacDraws(JKEY, PKEY, salts=n_salts)
        rt = pc.Runtime(rram=pr, key=PKEY, draw=draws)
        step = ptl.make_train_step(
            mod, cfg, TrainConfig(**dict(kw, remat=remat)), rt)
        _, state, m = step(p, popt.adamw_init(p), torch_batch(batch))
        out[remat] = (m, state, draws.calls, rt._salt)
    m, state, calls, salt = out["none"]
    assert calls == seq * 2 and salt == n_salts
    assert rel(m["loss"], jm["loss"]) <= TOL
    for (path, a), b, bound in zip(pPM.tree_paths(state.m),
                                   jax.tree.leaves(jstate.m), bounds):
        b = np.asarray(b)
        assert (not b.any() and not bool(a.any())) or rel(a, b) <= bound, \
            (path, bound)
    m_r, state_r, calls_r, salt_r = out["block"]
    assert sorted(calls_r) == sorted(calls + body * cfg.n_layers * 2)
    assert salt_r == salt and torch.equal(m_r["loss"], m["loss"])
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(pPM.tree_paths(state_r.m), pPM.tree_paths(state.m)))
