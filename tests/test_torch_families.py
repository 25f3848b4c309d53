"""The port's attention-based families held to the JAX package's on reduced
mixtral-8x7b, phi3.5-moe-42b-a6.6b, whisper-tiny and llama-3.2-vision-11b:
the parameter specs, ``forward`` and ``loss``, digital, on the reference's
programmed image with the input DAC off, and with the reference's DAC
draws injected in its key schedule; the DAC keys each family's scans hand
out (recorded from the reference under ``jit``); and the sliding-window
cache wrapping (serving: ``test_torch_families_serve.py``).  llama-vision's cross-layer ``gate``,
zero at init, is set to 0.7 on both sides so the cross path shows.
Inputs are made with numpy from fixed seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (ARCHS, GATE, JKEY, MODES, PKEY,
                             expected_salts, hidden, make_batch, np_tree,
                             reference_model, rram_cfgs, runtimes,
                             torch_batch, with_self_images)
from _torch_port import DacDraws, few_threads, rel, to_np  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.models import common as jc
from repro.models import params as jPM
from repro.models import transformer as jtf
from repro_torch.configs import get_arch, model_module
from repro_torch.interop import params_from_numpy
from repro_torch.models import common as pc
from repro_torch.models import params as pPM
from repro_torch.models import transformer as ptf

TOL = 1e-5
B = 2


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(reference cfg, port cfg, reference module, port module, reference
    digital params, reference programmed params)."""
    jcfg, jmod, jparams, jprog = reference_model(request.param)
    cfg = get_arch(request.param).reduced()
    return jcfg, cfg, jmod, model_module(cfg), jparams, jprog


# -------------------------------------------------------------------- specs
def test_specs_match(arch):
    """Paths, shapes, dtypes, logical axes and init of every leaf; the
    materialized tree's sorted walk; the gate zero at init."""
    jcfg, cfg, jmod, mod, jparams, _ = arch
    specs, jspecs = mod.init_specs(cfg), jmod.init_specs(jcfg)
    got = pPM.tree_paths(specs)
    want = jPM.tree_paths(jspecs, is_leaf=jPM.is_spec)
    assert [(p, s.shape, s.axes, s.init, s.scale) for p, s in got] == \
        [(p, s.shape, s.axes, s.init, s.scale) for p, s in want]
    params = pPM.materialize(specs, 0, device="cpu")
    assert [(p, tuple(a.shape)) for p, a in pPM.tree_paths(params)] == \
        [(p, b.shape) for p, b in jPM.tree_paths(jparams)]
    absd = pPM.tree_paths(pPM.abstract(specs, torch.bfloat16))
    jabs = jPM.tree_paths(jPM.abstract(jspecs, jnp.bfloat16))
    assert [(p, a.shape, str(a.dtype).split(".")[-1]) for p, a in absd] == \
        [(p, b.shape, str(b.dtype)) for p, b in jabs]
    if cfg.family == "llama_vision":
        gate = params["super"]["cross"]["attn"]["gate"]
        assert gate.shape == (cfg.n_layers // cfg.cross_attn_every,)
        assert bool((gate == 0).all())


def test_interop_carries_the_cross_gate():
    """``params_from_numpy`` carries the gate as a 0-d tensor (one cross
    layer's spec) and as the stacked ``(n_super,)`` vector, values kept."""
    jcfg = jget_arch("llama-3.2-vision-11b").reduced()
    one = jPM.materialize(jc.attention_specs(jcfg, cross=True),
                          jax.random.PRNGKey(3))
    one["gate"] = jnp.asarray(0.25, jnp.float32)
    p = params_from_numpy(np_tree(one), "cpu")
    assert p["gate"].ndim == 0 and float(p["gate"]) == 0.25
    assert p["gate"].dtype == torch.float32
    _, _, jp, _ = reference_model("llama-3.2-vision-11b")
    g = params_from_numpy(np_tree(jp), "cpu")["super"]["cross"]["attn"]
    assert tuple(g["gate"].shape) == jp["super"]["cross"]["attn"]["gate"] \
        .shape and bool((g["gate"] == np.float32(GATE)).all())


# ------------------------------------------------------------ forward, loss
@pytest.mark.parametrize("mode", MODES)
def test_forward_and_loss_match(arch, mode):
    jcfg, cfg, jmod, mod, jparams, jprog = arch
    jp = jparams if mode == "digital" else jprog
    p = params_from_numpy(np_tree(jp), "cpu")
    batch = make_batch(cfg, B, 7, 60)
    pbatch = torch_batch(batch)
    jrt, rt = runtimes(mode)
    want = jtf.logits_fn(jp, hidden(jmod, jp, batch, jcfg, jrt), jcfg, jrt)
    got = ptf.logits_fn(p, hidden(mod, p, pbatch, cfg, rt), cfg, rt)
    assert got.shape == want.shape and rel(got, want) <= TOL
    assert rt._salt == jrt._salt
    jrt, rt = runtimes(mode)
    assert rel(mod.loss(p, pbatch, cfg, rt),
               jmod.loss(jp, batch, jcfg, jrt)) <= TOL
    if cfg.family == "llama_vision" and mode == "digital":
        # The cross path shows: with the gate back at zero the logits move.
        attn = p["super"]["cross"]["attn"]
        attn["gate"] = torch.zeros_like(attn["gate"])
        shut = ptf.logits_fn(p, hidden(mod, p, pbatch, cfg, None), cfg, None)
        assert rel(shut, got) > 1e-3


@pytest.mark.parametrize("name", ARCHS)
def test_dac_keys_follow_the_references_trace(name, monkeypatch):
    """Recorded from the reference's ``_encode_act`` under ``jit``: every
    scan body is traced once (MoE: the attention body's 4 salts; whisper:
    the encoder body's, then the decoder body's; llama-vision, at two
    super layers of two self layers each, the self layers given images by
    hand so the nesting shows: the inner self body's, then the cross
    layer's), and the head takes the next.  The port's loops take the
    same keys call by call."""
    kw = {"n_layers": 6, "cross_attn_every": 3} \
        if name == "llama-3.2-vision-11b" else {}
    jcfg, jmod, _, jprog = reference_model(name, **kw)
    cfg = dataclasses.replace(get_arch(name).reduced(), **kw)
    mod = model_module(cfg)
    jr, pr = rram_cfgs()
    self_analog = cfg.family == "llama_vision"
    if self_analog:
        jprog = with_self_images(jprog)
    p = params_from_numpy(np_tree(jprog), "cpu")
    batch = make_batch(cfg, 1, 5, 61)
    seen = []
    real = jc._encode_act
    monkeypatch.setattr(jc, "_encode_act",
                        lambda x, key, c: seen.append(x.shape) or
                        real(x, key, c))

    def run(prm, bt, key):
        rt = jc.Runtime(rram=jr, key=key)
        return jtf.logits_fn(prm, hidden(jmod, prm, bt, jcfg, rt), jcfg, rt)

    want = jax.jit(run)(jprog, {k: v for k, v in batch.items()
                                if k != "labels"}, JKEY)
    seq, n_salts = expected_salts(cfg, self_analog)
    assert len(seen) == n_salts
    draws = DacDraws(JKEY, PKEY, salts=n_salts)
    rt = pc.Runtime(rram=pr, key=PKEY, draw=draws)
    got = ptf.logits_fn(p, hidden(mod, p, torch_batch(batch), cfg, rt), cfg,
                        rt)
    assert draws.calls == [(None, s) for s in seq]
    assert rt._salt == n_salts and rel(got, want) <= TOL


# ------------------------------------------------------------ sliding window
def test_mixtral_circular_swa_cache_matches_teacher_forcing():
    """The port's twin of the reference's test of that name, at
    ``swa_window`` 8: a 16-token prefill into an 8-slot circular cache and
    three decode steps agree with the port's full-sequence forward (2e-3,
    the reference's bound), and with the reference's own prefill and
    decode steps to 1e-5."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as pmoe
    jcfg = dataclasses.replace(jget_arch("mixtral-8x7b").reduced(),
                               swa_window=8)
    cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(),
                              swa_window=8)
    jp = jPM.materialize(jmoe.init_specs(jcfg), jax.random.PRNGKey(0))
    p = params_from_numpy(np_tree(jp), "cpu")
    # The reference test's tokens.  Teacher forcing is exact for an MoE
    # only where no expert overflows its capacity in either pass (the
    # capacity follows the pass's token count); on these it does not.
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 20), 0,
                                           cfg.vocab))
    tt = torch.from_numpy(tokens)
    h, _, _ = pmoe.forward(p, tt, cfg, None)
    full = to_np(ptf.logits_fn(p, h, cfg, None))
    lg, c = pmoe.prefill(p, {"tokens": tt[:, :16]}, cfg, None, 8)
    jlg, jcache = jmoe.prefill(jp, {"tokens": tokens[:, :16]}, jcfg,
                               jc.Runtime(), 8)
    assert c["k"].shape[2] == 8 and rel(lg, jlg) <= TOL
    np.testing.assert_allclose(to_np(lg[:, 0]), full[:, 15], rtol=2e-3,
                               atol=2e-3)
    for t in range(16, 19):
        lg, c = pmoe.decode_step(p, tt[:, t:t + 1], c, cfg, None)
        jlg, jcache = jmoe.decode_step(jp, tokens[:, t:t + 1], jcache, jcfg,
                                       jc.Runtime())
        assert rel(lg, jlg) <= TOL and rel(c["k"], jcache["k"]) <= TOL
        np.testing.assert_allclose(to_np(lg[:, 0]), full[:, t], rtol=2e-3,
                                   atol=2e-3)
    assert int(c["len"][0]) == 19
