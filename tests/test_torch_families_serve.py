"""The port's attention-based families served, held to the JAX package's
serving path on reduced mixtral-8x7b, phi3.5-moe-42b-a6.6b, whisper-tiny
and llama-3.2-vision-11b: prefill and four decode steps (logits and
caches, whisper's encoder states and llama-vision's patches carried along)
and ``Server.generate`` (tokens), digital, on the reference's programmed
image with the input DAC off, and with the reference's DAC draws injected
in its key schedule (prefill under ``fold_in(base, 0)``, decode step ``t``
under ``fold_in(base, t + 1)``).  llama-vision's cross-layer ``gate``, zero
at init, is set to 0.7 on both sides.  Prompts are made with numpy from
fixed seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (ARCHS, JKEY, MODES, PKEY, expected_salts,
                             make_batch, np_tree, reference_model, runtimes,
                             torch_batch)
from _torch_port import DacDraws, few_threads, rel, to_np  # noqa: F401
from repro.train.serve import Server as JServer
from repro_torch.configs import get_arch, model_module
from repro_torch.core.prng import fold_in
from repro_torch.interop import params_from_numpy
from repro_torch.train.serve import Server

TOL = 1e-5
B, T, NEW, MAX_LEN = 2, 6, 5, 12


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(reference cfg, port cfg, reference module, port module, reference
    digital params, reference programmed params)."""
    jcfg, jmod, jparams, jprog = reference_model(request.param)
    cfg = get_arch(request.param).reduced()
    return jcfg, cfg, jmod, model_module(cfg), jparams, jprog


# ---------------------------------------------------------------- serving
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
    batch = make_batch(cfg, B, T, 70)
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
            "got_steps": got_steps,
            "want_tokens": want_tokens, "jcaches": jcaches,
            "caches": caches,
            # The reference's fused Server (one more compile) with the DAC
            # on; its step loop above is keyed as its Server keys it.
            "server_tokens": np.asarray(jsrv.generate(
                {k: jnp.asarray(v) for k, v in batch.items()}, NEW))
            if mode == "dac_on" else None}


def kv_of(caches, family):
    return caches if family == "moe" else caches["kv"]


def test_prefill_and_decode_match(served):
    """Last-token logits of prefill and of four decode steps (fed the same
    tokens) within 1e-5, and the caches after the last step: the KV stacks
    and their lengths, and the encoder states / patches carried along."""
    for step, (got, want) in enumerate(zip(served["got_steps"],
                                           served["want_steps"])):
        assert got.shape == want.shape and rel(got, want) <= TOL, step
    fam = served["cfg"].family
    jkv, kv = kv_of(served["jcaches"], fam), kv_of(served["caches"], fam)
    assert np.array_equal(to_np(kv["len"]), np.asarray(jkv["len"]))
    assert int(kv["len"].reshape(-1)[0]) == T + NEW - 1
    assert rel(kv["k"], jkv["k"]) <= TOL and rel(kv["v"], jkv["v"]) <= TOL
    if fam == "whisper":
        assert rel(served["caches"]["enc"], served["jcaches"]["enc"]) <= TOL
    if fam == "llama_vision":
        assert np.array_equal(to_np(served["caches"]["patches"]),
                              served["batch"]["patches"])


def test_server_generate_matches(served):
    """The port's ``Server.generate`` (its eager loop and keys) against the
    reference's jitted step loop above (keyed as its Server's decode scan
    keys it) and, with the DAC on, against the reference's fused
    ``Server.generate`` too: the same greedy tokens.  With the DAC on
    every pass takes the family's salts."""
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
        seq, _ = expected_salts(served["cfg"])
        cfg = served["cfg"]
        if cfg.family == "whisper":
            # A decode step runs no encoder (the caches carry its states):
            # the decoder body's salts start at 1, the head's after them.
            dec = list(range(1, 11))
            want_calls = [(0, s) for s in seq] + [
                (t, s) for t in range(1, NEW)
                for s in dec * cfg.n_layers + [11]]
        else:
            want_calls = [(t, s) for t in range(NEW) for s in seq]
        assert rt.draw.calls == want_calls
