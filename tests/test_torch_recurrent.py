"""The port's recurrent families held to the JAX package's: the four
chunked linear-attention functions (``repro.models.linear_attention``) on
one chunk, on two (the inter-chunk scan) and from a given state, with
log-decays past both clamp bounds, and each against its own single-token
recurrence; then RWKV-6 and Zamba2 (Mamba-2) on the reduced rwkv6-1.6b,
zamba2-1.2b and zamba2-1.2b at 5 layers (two groups of two and a tail of
one): the parameter specs, ``forward`` and ``loss`` digital, on the
reference's programmed image with the input DAC off and with the
reference's DAC draws injected; the DAC keys each family's loops hand out
(recorded from the reference under ``jit``); and the leaves
``program_rram`` programs.  Serving: ``test_torch_recurrent_serve.py``.
Inputs are made with numpy from fixed seeds."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_families import (JKEY, MODES, PKEY, hidden, make_batch,
                             np_tree, recurrent_salts, reference_model,
                             rram_cfgs, runtimes, torch_batch)
from _torch_port import (DacDraws, few_threads,  # noqa: F401
                         rel, rram_program_etas)
from repro.configs import get_arch as jget_arch
from repro.models import common as jc
from repro.models import linear_attention as jla
from repro.models import params as jPM
from repro.models import rram as jrram
from repro.models import transformer as jtf
from repro_torch.configs import get_arch, model_module
from repro_torch.interop import params_from_numpy
from repro_torch.models import common as pc
from repro_torch.models import linear_attention as pla
from repro_torch.models import params as pPM
from repro_torch.models import rram as prram
from repro_torch.models import rwkv6 as prwkv
from repro_torch.models import transformer as ptf

TOL = 1e-5
B = 2
# (arch, config changes): the reduced zamba2 has one group and no tail, so
# the 5-layer one adds a second shared-block invocation and an analog tail.
CONFIGS = [("rwkv6-1.6b", ()), ("zamba2-1.2b", ()),
           ("zamba2-1.2b", (("n_layers", 5),))]
IDS = ["rwkv6", "zamba2", "zamba2-5"]


def cfgs(name, kw=()):
    kw = dict(kw)
    return (dataclasses.replace(jget_arch(name).reduced(), **kw),
            dataclasses.replace(get_arch(name).reduced(), **kw))


# ------------------------------------------------------ linear attention
def la_inputs(fn, t, seed):
    """Numpy inputs of ``fn`` ("wkv" or "ssd") over ``t`` tokens: B = 2,
    H = 3, head width 16; log-decays -exp(N(0, 1)) (about a third below
    the -1.5 clamp) with every fifth token at -1e-12 (above both upper
    clamps); a random state."""
    rng = np.random.default_rng(seed)
    h, d = 3, 16
    q, k, v = (rng.standard_normal((B, t, h, d)).astype(np.float32)
               for _ in range(3))
    lshape = (B, t, h, d) if fn == "wkv" else (B, t, h)
    logd = -np.exp(rng.standard_normal(lshape)).astype(np.float32)
    logd[:, ::5] = -1e-12
    u = rng.standard_normal((h, d)).astype(np.float32)
    s0 = rng.standard_normal((B, h, d, d)).astype(np.float32)
    return q, k, v, logd, u, s0


def chunked(mod, fn, q, k, v, logd, u, s0, chunk):
    if fn == "wkv":
        return mod.chunked_wkv(q, k, v, logd, u, state0=s0, chunk=chunk)
    return mod.chunked_ssd(q, k, v, logd, state0=s0, chunk=chunk)


def tt(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("fn", ["wkv", "ssd"])
@pytest.mark.parametrize("t", [8, 64])
@pytest.mark.parametrize("given_state", [False, True])
def test_chunked_recurrence_matches(fn, t, given_state):
    """``chunked_wkv`` / ``chunked_ssd`` on one chunk (T = 8) and on two
    (T = 64, chunk 32: the inter-chunk scan), from zeros or a given state:
    outputs and final state within 1e-5 of the reference's."""
    q, k, v, logd, u, s0 = la_inputs(fn, t, 10 + t)
    s0 = s0 if given_state else None
    c = min(32, t)
    want_o, want_s = chunked(jla, fn, q, k, v, logd, u, s0, c)
    got_o, got_s = chunked(pla, fn, *tt(q, k, v, logd, u, s0), c)
    assert got_o.dtype == torch.float32 and got_s.dtype == torch.float32
    assert got_o.shape == want_o.shape and got_s.shape == want_s.shape
    assert rel(got_o, want_o) <= TOL and rel(got_s, want_s) <= TOL


@pytest.mark.parametrize("fn", ["wkv", "ssd"])
def test_decode_step_matches(fn):
    """``wkv_decode_step`` / ``ssd_decode_step`` from a random state, the
    log-decays past both clamps: output and state within 1e-5."""
    q, k, v, logd, u, s0 = la_inputs(fn, 5, 20)
    args = (q[:, 0], k[:, 0], v[:, 0], logd[:, 0])
    if fn == "wkv":
        want = jla.wkv_decode_step(*args, u, s0)
        got = pla.wkv_decode_step(*tt(*args, u, s0))
    else:
        want = jla.ssd_decode_step(*args, s0)
        got = pla.ssd_decode_step(*tt(*args, s0))
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel(g, w) <= TOL


@pytest.mark.parametrize("fn", ["wkv", "ssd"])
@pytest.mark.parametrize("t", [8, 64])
def test_chunked_form_equals_its_token_recurrence(fn, t):
    """The chunked form against the port's own single-token steps run in
    order from the same state: RWKV reads S_{t-1} plus the bonus, SSD
    updates S first, then reads it.  Every log-decay here lies inside both
    functions' clamps (the steps' upper clamp differs from SSD's chunked
    one), so the two are the same recurrence: outputs and final state
    within 1e-5."""
    q, k, v, logd, u, s0 = tt(*la_inputs(fn, t, 30 + t))
    logd = logd.clamp(max=-1e-6)
    o_chunk, s_chunk = chunked(pla, fn, q, k, v, logd, u, s0, min(32, t))
    s, outs = s0, []
    for i in range(t):
        if fn == "wkv":
            o, s = pla.wkv_decode_step(q[:, i], k[:, i], v[:, i],
                                       logd[:, i], u, s)
        else:
            o, s = pla.ssd_decode_step(q[:, i], k[:, i], v[:, i],
                                       logd[:, i], s)
        outs.append(o)
    assert rel(o_chunk, torch.stack(outs, dim=1)) <= TOL
    assert rel(s_chunk, s) <= TOL


def test_chunk_must_divide_the_sequence_and_dtypes_hold():
    """T not a multiple of the chunk raises ``AssertionError`` in both
    packages; a bfloat16 input gives a bfloat16 output and a float32
    state."""
    for fn in ("wkv", "ssd"):
        q, k, v, logd, u, s0 = la_inputs(fn, 40, 40)
        with pytest.raises(AssertionError):
            chunked(jla, fn, q, k, v, logd, u, None, 32)
        with pytest.raises(AssertionError):
            chunked(pla, fn, *tt(q, k, v, logd, u), None, 32)
        bf = [a.to(torch.bfloat16) for a in tt(q, k, v)]
        o, s = chunked(pla, fn, *bf, *tt(logd, u), None, 8)
        assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert pla.LOG_CLAMP == jla.LOG_CLAMP == -1.5


# ------------------------------------------------------------ the families
@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def arch(request):
    """(reference cfg, port cfg, reference module, port module, reference
    digital params, reference programmed params)."""
    name, kw = request.param
    jcfg, jmod, jparams, jprog = reference_model(name, **dict(kw))
    _, cfg = cfgs(name, kw)
    return jcfg, cfg, jmod, model_module(cfg), jparams, jprog


def test_specs_match(arch):
    """Paths, shapes, logical axes and init of every leaf, and the
    materialized tree's sorted walk."""
    jcfg, cfg, jmod, mod, jparams, _ = arch
    got = pPM.tree_paths(mod.init_specs(cfg))
    want = jPM.tree_paths(jmod.init_specs(jcfg), is_leaf=jPM.is_spec)
    assert [(p, s.shape, s.axes, s.init, s.scale) for p, s in got] == \
        [(p, s.shape, s.axes, s.init, s.scale) for p, s in want]
    params = pPM.materialize(mod.init_specs(cfg), 0, device="cpu")
    assert [(p, tuple(a.shape)) for p, a in pPM.tree_paths(params)] == \
        [(p, b.shape) for p, b in jPM.tree_paths(jparams)]
    if cfg.family == "rwkv6":
        tm = params["layers"]["tm"]
        assert tm["u"].shape == (cfg.n_layers, cfg.d_model
                                 // cfg.ssm_head_dim, cfg.ssm_head_dim)
        assert tm["w_lora_a"]["w"].shape[-1] == prwkv.LORA_R == 64


@pytest.mark.parametrize("mode", MODES)
def test_forward_and_loss_match(arch, mode):
    """Logits of a 64-token pass (two chunks) and the loss, within 1e-5,
    each family's salts spent as the reference spends them."""
    jcfg, cfg, jmod, mod, jparams, jprog = arch
    jp = jparams if mode == "digital" else jprog
    p = params_from_numpy(np_tree(jp), "cpu")
    batch = make_batch(cfg, B, 64, 80)
    pbatch = torch_batch(batch)
    jrt, rt = runtimes(mode)
    want = jtf.logits_fn(jp, hidden(jmod, jp, batch, jcfg, jrt), jcfg, jrt)
    got = ptf.logits_fn(p, hidden(mod, p, pbatch, cfg, rt), cfg, rt)
    assert got.shape == want.shape and rel(got, want) <= TOL
    assert rt._salt == jrt._salt
    jrt, rt = runtimes(mode)
    assert rel(mod.loss(p, pbatch, cfg, rt),
               jmod.loss(jp, batch, jcfg, jrt)) <= TOL


@pytest.mark.parametrize("name,kw", [
    ("rwkv6-1.6b", ()), ("zamba2-1.2b", (("n_layers", 8),
                                         ("attn_every", 3)))],
    ids=["rwkv6", "zamba2-8"])
def test_dac_keys_follow_the_references_trace(name, kw, monkeypatch):
    """Recorded from the reference's ``_encode_act`` under ``jit``: rwkv6's
    layer scan traces its body's nine dense calls once; zamba2 at 8 layers
    (two groups of three, a tail of two) draws six salts per shared-block
    invocation, none for the digital grouped blocks, and one set of six
    for its tail scan; the head takes the next.  The port's loops take the
    same keys call by call."""
    jcfg, jmod, _, jprog = reference_model(name, **dict(kw))
    _, cfg = cfgs(name, kw)
    mod = model_module(cfg)
    jr, pr = rram_cfgs()
    p = params_from_numpy(np_tree(jprog), "cpu")
    batch = make_batch(cfg, 1, 5, 81)
    seen = []
    real = jc._encode_act
    monkeypatch.setattr(jc, "_encode_act",
                        lambda x, key, c: seen.append(x.shape) or
                        real(x, key, c))

    def run(prm, tokens, key):
        rt = jc.Runtime(rram=jr, key=key)
        return jtf.logits_fn(prm, jmod.forward(prm, tokens, jcfg, rt)[0],
                             jcfg, rt)

    want = jax.jit(run)(jprog, batch["tokens"], JKEY)
    seq, n_salts = recurrent_salts(cfg)
    assert len(seen) == n_salts
    draws = DacDraws(JKEY, PKEY, salts=n_salts)
    rt = pc.Runtime(rram=pr, key=PKEY, draw=draws)
    got = ptf.logits_fn(p, mod.forward(p, torch.from_numpy(batch["tokens"]),
                                       cfg, rt)[0], cfg, rt)
    assert draws.calls == [(None, s) for s in seq]
    assert rt._salt == n_salts and rel(got, want) <= TOL


@pytest.mark.parametrize("name,kw", CONFIGS[::2], ids=["rwkv6", "zamba2-5"])
def test_program_rram_programs_the_references_leaves(name, kw):
    """With the reference's programming draws injected, the port programs
    the leaves the reference programs, with the same images and
    ``WriteStats``: rwkv6's every layer kernel and the head, ``w_lora_b``
    included; zamba2's tail, adapters, shared attention and head, its 4-D
    grouped mamba stacks left digital.  rwkv6's ``w_lora_b`` image is
    never read: garbage in it changes no logit."""
    jcfg, cfg = cfgs(name, kw)
    mod = model_module(cfg)
    _, jmod, jparams, _ = reference_model(name, **dict(kw))
    params = params_from_numpy(np_tree(jparams), "cpu")
    jr, pr = rram_cfgs(dw_dtype="float32")
    key = jax.random.PRNGKey(7)
    eta = rram_program_etas(jparams, jrram.crossbar_cfg(jr), key)
    jprog, jstats = jax.jit(lambda prm: jrram.program_rram(prm, jr, key))(
        jparams)
    prog, stats = prram.program_rram(params, pr, 123, eta=eta)
    got, want = pPM.tree_paths(prog), jPM.tree_paths(jprog)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert rel(a, np.asarray(b)) <= 1e-6, path
    programmed = {p[:-len("['w_tilde']")] for p, _ in got
                  if p.endswith("['w_tilde']")}
    kernels = {p[:-len("['w']")]: a.ndim for p, a in got
               if p.endswith("['w']")}
    assert programmed == {p for p, nd in kernels.items() if nd in (2, 3)}
    if cfg.family == "rwkv6":
        assert programmed == set(kernels)
        assert "['layers']['tm']['w_lora_b']" in programmed
    else:
        assert {p for p in kernels if p not in programmed} == {
            f"['groups']['{n}']" for n in
            ("out", "wB", "wC", "wdt", "wx", "wz")}
        assert all(kernels[p] == 4 for p in kernels if p not in programmed)
        assert {"['adapters_in']", "['adapters_out']", "['lm_head']",
                "['shared_attn']['attn']['wq']", "['tail']['wz']"} \
            <= programmed
    for f in ("energy_j", "latency_s", "final_delta"):
        assert getattr(stats, f) == pytest.approx(float(getattr(jstats, f)),
                                                  rel=1e-6), f
    assert stats.iterations == int(jstats.iterations)
    assert prram.programmed_kernel_shapes(prog) == \
        jrram.programmed_kernel_shapes(jprog)
    if cfg.family == "rwkv6":
        tokens = torch.from_numpy(make_batch(cfg, 1, 5, 82)["tokens"])
        _, rt = runtimes("dac_on")
        before = ptf.logits_fn(prog, mod.forward(prog, tokens, cfg, rt)[0],
                               cfg, rt)
        lb = prog["layers"]["tm"]["w_lora_b"]
        lb["w_tilde"] = torch.full_like(lb["w_tilde"], float("nan"))
        lb["dw"] = torch.full_like(lb["dw"], float("nan"))
        _, rt = runtimes("dac_on")
        after = ptf.logits_fn(prog, mod.forward(prog, tokens, cfg, rt)[0],
                              cfg, rt)
        assert torch.equal(before, after)
