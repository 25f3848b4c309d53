"""The port's recurrent families served, held to the JAX package's serving
path on the reduced rwkv6-1.6b and zamba2-1.2b at 5 layers (two groups of
two mamba blocks and a tail of one): prefill and four decode steps (logits
and every cache: rwkv6's WKV state and token shifts; zamba2's conv / SSM
states, the shared block's KV caches and their lengths) and
``Server.generate`` (tokens), digital, on the reference's programmed image
with the input DAC off, and with the reference's DAC draws injected in its
key schedule (prefill under ``fold_in(base, 0)``, decode step ``t`` under
``fold_in(base, t + 1)``); and a prompt of one chunk whose decode steps
equal the two-chunk forward pass, token by token; and ``chip_smoke.py``'s
phase 14 rehearsed on the CPU.  Prompts are made with numpy from fixed
seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (JKEY, MODES, PKEY, make_batch, np_tree,
                             recurrent_salts, reference_model, runtimes,
                             torch_batch)
from _torch_port import DacDraws, few_threads, rel, to_np  # noqa: F401
from repro.models import params as jPM
from repro.train.serve import Server as JServer
from repro_torch.configs import get_arch, model_module
from repro_torch.core.prng import fold_in
from repro_torch.interop import params_from_numpy
from repro_torch.models import params as pPM
from repro_torch.models import transformer as ptf
from repro_torch.train.serve import Server

TOL = 1e-5
B, T, NEW, MAX_LEN = 2, 6, 5, 12
CONFIGS = [("rwkv6-1.6b", ()), ("zamba2-1.2b", (("n_layers", 5),))]
IDS = ["rwkv6", "zamba2-5"]


def port_cfg(name, kw):
    return dataclasses.replace(get_arch(name).reduced(), **dict(kw))


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def arch(request):
    """(reference cfg, port cfg, reference module, port module, reference
    digital params, reference programmed params)."""
    name, kw = request.param
    jcfg, jmod, jparams, jprog = reference_model(name, **dict(kw))
    cfg = port_cfg(name, kw)
    return jcfg, cfg, jmod, model_module(cfg), jparams, jprog


@pytest.fixture(scope="module", params=MODES)
def served(request, arch):
    """Both packages served on the same prompt: the reference's prefill and
    decode steps (jitted, fed its own greedy tokens, keyed as its Server's
    scan keys them), and the port's steps fed the same tokens."""
    mode = request.param
    jcfg, cfg, jmod, mod, jparams, jprog = arch
    jrt, rt = runtimes(mode, steps=range(NEW + 1))
    jp = jparams if mode == "digital" else jprog
    p = params_from_numpy(np_tree(jp), "cpu")
    batch = make_batch(cfg, B, T, 90)
    del batch["labels"]
    jsrv = JServer(jmod, jcfg, jp, rt=jrt, max_len=MAX_LEN)
    base = jsrv._noise_base()

    def rt_at(key):
        return dataclasses.replace(jrt, key=key, _salt=0)

    jprefill = jax.jit(lambda prm, bt, key: jmod.prefill(
        prm, bt, jcfg, rt_at(key), MAX_LEN))
    jdecode = jax.jit(lambda prm, tok, caches, key: jmod.decode_step(
        prm, tok, caches, jcfg, rt_at(key)))
    logits, jcaches = jprefill(jp, batch, jax.random.fold_in(base, 0))
    want_steps = [np.asarray(logits)]
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    toks = [np.asarray(tok)]
    for t in range(NEW - 1):
        logits, jcaches = jdecode(jp, tok, jcaches,
                                  jax.random.fold_in(base, t + 1))
        want_steps.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    want_tokens = np.concatenate(toks, axis=1)
    srv = Server(mod, cfg, p, rt=rt, max_len=MAX_LEN)
    got_logits, caches = mod.prefill(
        p, torch_batch(batch), cfg,
        srv._rt_for(fold_in(srv._noise_base(), 0)), MAX_LEN)
    got_steps = [to_np(got_logits)]
    for t in range(NEW - 1):
        logits, caches = mod.decode_step(
            p, torch.from_numpy(want_tokens[:, t:t + 1]), caches, cfg,
            srv._rt_for(fold_in(srv._noise_base(), t + 1)))
        got_steps.append(to_np(logits))
    return {"mode": mode, "cfg": cfg, "mod": mod, "batch": batch,
            "params": p, "rt": rt, "want_steps": want_steps,
            "got_steps": got_steps, "want_tokens": want_tokens,
            "jcaches": jcaches, "caches": caches,
            # The reference's fused Server (one more compile) with the DAC
            # on; its step loop above is keyed as its Server keys it.
            "server_tokens": np.asarray(jsrv.generate(
                {k: jnp.asarray(v) for k, v in batch.items()}, NEW))
            if mode == "dac_on" else None}


def test_prefill_and_decode_match(served):
    """Last-token logits of prefill and of four decode steps (fed the same
    tokens) within 1e-5, and every cache leaf after the last step: rwkv6's
    ``S`` (float32) and token shifts; zamba2's grouped and tail conv / SSM
    states, the shared block's ``k`` / ``v`` and their lengths (kept on
    the host)."""
    for step, (got, want) in enumerate(zip(served["got_steps"],
                                           served["want_steps"])):
        assert got.shape == want.shape and rel(got, want) <= TOL, step
    got = pPM.tree_paths(served["caches"])
    want = jPM.tree_paths(served["jcaches"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, path
        if path.endswith("['len']"):
            assert a.device.type == "cpu" and np.array_equal(to_np(a), b)
            assert int(a[0]) == T + NEW - 1
        else:
            assert str(a.dtype).split(".")[-1] == str(b.dtype), path
            assert rel(a, b) <= TOL, path


def test_server_generate_matches(served):
    """The port's ``Server.generate`` (its eager loop and keys) against the
    reference's jitted step loop above and, with the DAC on, against the
    reference's fused ``Server.generate`` too: the same greedy tokens;
    with the DAC on every pass takes the family's salts."""
    want = served["want_tokens"]
    if served["server_tokens"] is not None:
        assert np.array_equal(served["server_tokens"], want)
    rt = served["rt"]
    if served["mode"] == "dac_on":
        rt = dataclasses.replace(rt, draw=DacDraws(
            JKEY, PKEY, steps=range(NEW + 1), salts=24))
    srv = Server(served["mod"], served["cfg"], served["params"], rt=rt,
                 max_len=MAX_LEN)
    got = to_np(srv.generate(torch_batch(served["batch"]), NEW))
    assert got.shape == want.shape and got.dtype == np.int32
    assert np.array_equal(got, want)
    if served["mode"] == "dac_on":
        seq, _ = recurrent_salts(served["cfg"])
        assert rt.draw.calls == [(t, s) for t in range(NEW) for s in seq]


def test_one_chunk_prompt_then_decode_equals_the_two_chunk_pass(arch):
    """A 32-token prefill (one chunk) and 32 decode steps fed the next
    tokens give, step by step, the logits of one 64-token forward pass
    (two chunks: the inter-chunk scan) at those positions, within 1e-5:
    the O(1) state a decode step carries is the chunked form's.  On the
    reference's programmed image with the DAC off."""
    jcfg, cfg, jmod, mod, _, jprog = arch
    p = params_from_numpy(np_tree(jprog), "cpu")
    _, rt = runtimes("dac_off")
    tokens = torch.from_numpy(make_batch(cfg, B, 64, 91)["tokens"])
    full = ptf.logits_fn(p, mod.forward(p, tokens, cfg, rt)[0], cfg, rt)
    logits, caches = mod.prefill(p, {"tokens": tokens[:, :32]}, cfg, rt, 64)
    assert rel(logits[:, 0], full[:, 31]) <= TOL
    for t in range(32, 64):
        logits, caches = mod.decode_step(p, tokens[:, t:t + 1], caches, cfg,
                                         rt)
        assert rel(logits[:, 0], full[:, t]) <= TOL, t
    with pytest.raises(AssertionError):      # 40 > 32 is not a multiple
        mod.prefill(p, {"tokens": tokens[:, :40]}, cfg, rt, 64)


def test_chip_smoke_recurrent_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 14 at the reduced rwkv6-1.6b and zamba2-1.2b
    at 5 layers on the CPU (``lm_probe.py rehearse-recurrent``, the same
    stand-ins as phase 12's rehearsal): every check passes, and a decode
    step at 4 rows launches one ec_rmatmul and one stencil_denoise per
    analog dense: 9 a layer and the head for rwkv6, 6 a shared-block
    invocation and 6 for the tail's scan and the head for zamba2."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(repo / "lm_probe.py"), "rehearse-recurrent"],
        text=True, capture_output=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("rehearsal of phase 14")
    assert "{'ec_rmatmul': 443, 'stencil_denoise': 209}" in lines[-1]
    for tag in ("[14a]", "[14b]"):
        step = [ln for ln in lines if ln.startswith(f"{tag} prefill:")]
        assert len(step) == 1 and "a decode step: {'ec_rmatmul': 19, " \
            "'stencil_denoise': 19} (expected 19 + 19)" in step[0], tag
    assert any(ln.startswith("[14a] 1 x 64: 145 + 19 launches a prefill")
               for ln in lines)
