"""The port's serving path held to the JAX package's: ``prefill`` and each
``decode_step`` (logits and caches), ``Server.generate`` (tokens) and the
Server's programming, on reduced qwen3-1.7b, yi-9b and nemotron-4-15b,
digital and on the programmed image (the reference's image carried across),
with the input DAC off and with the reference's DAC draws injected in its
key schedule (prefill under ``fold_in(base, 0)``, decode step ``t`` under
``fold_in(base, t + 1)``, dense call ``s`` of a pass under ``fold_in(.,
s)``).  Prompts are made with numpy from fixed seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import DacDraws, few_threads, rel, to_np  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.configs.base import RRAMBackendConfig as JRRAM
from repro.models import common as jc
from repro.models import params as jPM
from repro.models import rram as jrram
from repro.models import transformer as jtf
from repro.train.serve import Server as JServer
from repro_torch.configs import get_arch
from repro_torch.configs.base import RRAMBackendConfig
from repro_torch.core.prng import fold_in
from repro_torch.interop import params_from_numpy
from repro_torch.models import common as pc
from repro_torch.models import rram as prram
from repro_torch.models import transformer as ptf
from repro_torch.train.serve import Server, greedy_generate

TOL = 1e-5
ARCHS = ["qwen3-1.7b", "yi-9b", "nemotron-4-15b"]
MODES = ["digital", "dac_off", "dac_on"]
B, T, NEW, MAX_LEN = 2, 6, 4, 12
JKEY, PKEY = jax.random.PRNGKey(9), 9


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rram_cfgs(**kw):
    kw = {"enabled": True, "cell_rows": 32, "cell_cols": 32, **kw}
    return JRRAM(**kw), RRAMBackendConfig(**kw)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(name, reference cfg, port cfg, reference digital params,
    reference programmed params)."""
    jcfg = jget_arch(request.param).reduced()
    jparams = jPM.materialize(jtf.init_specs(jcfg), jax.random.PRNGKey(0))
    jprog, _ = jrram.program_rram(jparams, rram_cfgs()[0],
                                  jax.random.PRNGKey(7))
    return (request.param, jcfg, get_arch(request.param).reduced(), jparams,
            jprog)


def runtimes(mode, **kw):
    """(reference Runtime, port Runtime) of a serving mode."""
    if mode == "digital":
        return jc.Runtime(**kw), pc.Runtime(**kw)
    jr, pr = rram_cfgs(encode_inputs=mode == "dac_on")
    draws = DacDraws(JKEY, PKEY, steps=range(NEW + 1))
    return (jc.Runtime(rram=jr, key=JKEY, **kw),
            pc.Runtime(rram=pr, key=PKEY, draw=draws, **kw))


@pytest.fixture(scope="module", params=MODES)
def served(request, arch):
    """Both packages served on the same prompt: the reference's prefill and
    decode steps (jitted, fed the reference's own greedy tokens, each keyed
    as its Server's scan keys them), its ``Server.generate``, and the
    port's steps fed the same tokens."""
    mode = request.param
    name, jcfg, cfg, jparams, jprog = arch
    jrt, rt = runtimes(mode)
    jp = jparams if mode == "digital" else jprog
    p = params_from_numpy(np_tree(jp), "cpu")
    prompt = np.random.default_rng(70).integers(0, cfg.vocab, (B, T)) \
        .astype(np.int32)
    jsrv = JServer(jtf, jcfg, jp, rt=jrt, max_len=MAX_LEN)
    base = jsrv._noise_base()

    def rt_at(key):
        return dataclasses.replace(jrt, key=key, _salt=0)

    jprefill = jax.jit(lambda prm, tok, key: jtf.prefill(
        prm, {"tokens": tok}, jcfg, rt_at(key), MAX_LEN))
    jdecode = jax.jit(lambda prm, tok, caches, key: jtf.decode_step(
        prm, tok, caches, jcfg, rt_at(key)))
    want_logits, jcaches = jprefill(jp, prompt, jax.random.fold_in(base, 0))
    want_steps = [np.asarray(want_logits)]
    tok = jnp.argmax(want_logits[:, -1], -1)[:, None].astype(jnp.int32)
    toks = [np.asarray(tok)]
    for t in range(NEW - 1):
        logits, jcaches = jdecode(jp, tok, jcaches,
                                  jax.random.fold_in(base, t + 1))
        want_steps.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    want_tokens = np.concatenate(toks, axis=1)
    srv = Server(ptf, cfg, p, rt=rt, max_len=MAX_LEN)
    got_logits, caches = ptf.prefill(
        p, {"tokens": torch.from_numpy(prompt)}, cfg,
        srv._rt_for(fold_in(srv._noise_base(), 0)), MAX_LEN)
    got_steps = [to_np(got_logits)]
    for t in range(NEW - 1):
        logits, caches = ptf.decode_step(
            p, torch.from_numpy(want_tokens[:, t:t + 1]), caches, cfg,
            srv._rt_for(fold_in(srv._noise_base(), t + 1)))
        got_steps.append(to_np(logits))
    return {"mode": mode, "cfg": cfg, "prompt": prompt, "params": p,
            "rt": rt, "want_steps": want_steps, "want_tokens": want_tokens,
            "server_tokens": np.asarray(jsrv.generate(
                {"tokens": jnp.asarray(prompt)}, NEW)),
            "got_steps": got_steps, "jcaches": jcaches, "caches": caches}


def test_prefill_and_decode_logits_match(served):
    """Last-token logits of prefill and of every decode step (both fed the
    same tokens) within 1e-5, and the caches after the last step."""
    for step, (got, want) in enumerate(zip(served["got_steps"],
                                           served["want_steps"])):
        assert got.shape == want.shape
        assert rel(got, want) <= TOL, step
    jc_, pc_ = served["jcaches"], served["caches"]
    assert np.array_equal(to_np(pc_["len"]), np.asarray(jc_["len"]))
    assert rel(pc_["k"], jc_["k"]) <= TOL and rel(pc_["v"], jc_["v"]) <= TOL


def assert_tokens_agree(got, want, steps):
    """Equal up to the first step where they differ; there the reference's
    top-2 logit gap must be within 10x the logits bound (a near tie)."""
    for t in range(want.shape[1]):
        for b in range(want.shape[0]):
            if got[b, t] != want[b, t]:
                row = steps[t][b, -1]
                top2 = np.sort(row)[-2:]
                gap = top2[1] - top2[0]
                assert gap <= 10 * TOL * np.linalg.norm(row), (b, t, gap)
                return


def test_server_generate_matches(served):
    """The port's ``Server.generate`` (its own eager loop and keys) against
    the reference's fused ``Server.generate``; the reference's jitted
    step loop above gives the same tokens as its Server."""
    want = served["server_tokens"]
    assert_tokens_agree(served["want_tokens"], want, served["want_steps"])
    rt = served["rt"]
    if served["mode"] == "dac_on":
        rt = dataclasses.replace(rt, draw=DacDraws(JKEY, PKEY,
                                                   steps=range(NEW + 1)))
    srv = Server(ptf, served["cfg"], served["params"], rt=rt,
                 max_len=MAX_LEN)
    got = to_np(srv.generate({"tokens": torch.from_numpy(served["prompt"])},
                             NEW))
    assert got.shape == want.shape and got.dtype == np.int32
    assert_tokens_agree(got, want, served["want_steps"])
    if served["mode"] == "dac_on":
        # Each pass (prefill, then the decode steps) takes the body's salts
        # in every layer, then the head's.
        cfg = served["cfg"]
        body = 7 if cfg.act == "silu_gated" else 6
        assert rt.draw.calls == [
            (t, s) for t in range(NEW)
            for s in list(range(1, body + 1)) * cfg.n_layers + [body + 1]]


def test_prefill_takes_flash_and_matches(arch):
    """A prompt over ``flash_threshold``: prefill chunks its attention in
    both packages (16 x 16 > 64, chunks of 4 x 8) with the DAC on."""
    name, jcfg, cfg, _, jprog = arch
    jrt, rt = runtimes("dac_on", flash_threshold=64, q_chunk=4, kv_chunk=8)
    prompt = np.random.default_rng(71).integers(0, cfg.vocab, (1, 16)) \
        .astype(np.int32)
    jsrv = JServer(jtf, jcfg, jprog, rt=jrt, max_len=16)
    want_tok, jcaches = jsrv.prefill({"tokens": jnp.asarray(prompt)})
    srv = Server(ptf, cfg, params_from_numpy(np_tree(jprog), "cpu"), rt=rt,
                 max_len=16)
    tok, caches = srv.prefill({"tokens": torch.from_numpy(prompt)})
    assert np.array_equal(to_np(tok), np.asarray(want_tok))
    assert rel(caches["k"], jcaches["k"]) <= TOL
    assert rt.draw.calls and all(step == 0 for step, _ in rt.draw.calls)


def test_server_programs_once(arch):
    """A Server handed digital params programs them under its key (default
    7, the reference's PRNGKey(7)), billing what the reference's Server
    bills; handed programmed params it programs nothing."""
    name, jcfg, cfg, jparams, jprog = arch
    jr, pr = rram_cfgs()
    jsrv = JServer(jtf, jcfg, jparams, rt=jc.Runtime(rram=jr),
                   max_len=MAX_LEN)
    params = params_from_numpy(np_tree(jparams), "cpu")
    srv = Server(ptf, cfg, params, rt=pc.Runtime(rram=pr), max_len=MAX_LEN)
    assert srv.key == 7 and prram.is_programmed(srv.params)
    assert srv.program_dispatches == jsrv.program_dispatches
    for f in ("energy_j", "latency_s", "final_delta"):
        assert getattr(srv.write_stats, f) == pytest.approx(
            float(getattr(jsrv.write_stats, f)), rel=1e-6)
    same, _ = prram.program_rram(params, pr, 7)
    assert torch.equal(srv.params["lm_head"]["w_tilde"],
                       same["lm_head"]["w_tilde"])
    again = Server(ptf, cfg, srv.params, rt=pc.Runtime(rram=pr))
    assert again.program_dispatches == 0 and again.write_stats is None
    assert again.params is srv.params
    digital = Server(ptf, cfg, params)
    assert digital.engine is None and not prram.is_programmed(digital.params)


def test_greedy_generate_and_one_token(arch):
    name, jcfg, cfg, jparams, _ = arch
    params = params_from_numpy(np_tree(jparams), "cpu")
    prompt = torch.from_numpy(np.random.default_rng(72).integers(
        0, cfg.vocab, (B, T)).astype(np.int32))
    out = greedy_generate(ptf, params, cfg, {"tokens": prompt}, 3,
                          max_len=MAX_LEN)
    srv = Server(ptf, cfg, params, max_len=MAX_LEN)
    assert torch.equal(out, srv.generate({"tokens": prompt}, 3))
    first = srv.generate({"tokens": prompt}, 1)
    assert first.shape == (B, 1) and torch.equal(first, out[:, :1])
    want = np.asarray(JServer(jtf, jcfg, jparams, max_len=MAX_LEN).generate(
        {"tokens": jnp.asarray(to_np(prompt))}, 1))
    assert np.array_equal(to_np(first), want)


def test_chip_smoke_lm_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 12 is a function with size arguments: at the
    reduced qwen3-1.7b on the CPU (``lm_probe.py rehearse``: synchronise and
    memory calls stubbed, the kernel wrappers counting launches as the
    CUDA path does) every check passes: the dense twin, the served
    requests' launch counts (one ec_rmatmul per 8 rows, one stencil per
    dense), a decode step's 15 + 15, flash in the long prefill, DAC-off
    logits against digital."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(repo / "lm_probe.py"), "rehearse"], text=True,
        capture_output=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("rehearsal of qwen3-1.7b")
    assert "'ec_rmatmul': 175, 'stencil_denoise': 105" in lines[-1]
    assert any("{'ec_rmatmul': 15, 'stencil_denoise': 15}" in ln
               for ln in lines)
    assert any("flash attention 2 calls (expected 2" in ln for ln in lines)


def test_chip_smoke_families_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 13 at the reduced mixtral-8x7b, whisper-tiny
    and llama-3.2-vision-11b on the CPU (``lm_probe.py rehearse-families``,
    the same stand-ins as phase 12's rehearsal): every check passes, the
    served requests' EC launches are what the families' analog denses
    give (one ec_rmatmul per 8 rows, the MoE experts and llama-vision's
    self layers digital), and the expert EC runs one ec_group_rmatmul
    launch per 8 capacity slots a stack."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(repo / "lm_probe.py"), "rehearse-families"],
        text=True, capture_output=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("rehearsal of phase 13")
    assert "'ec_rmatmul': 288, 'ec_group_rmatmul': 18, " \
        "'stencil_denoise': 162" in lines[-1]
    for tag in ("[13a]", "[13c]", "[13d]"):
        served = [ln for ln in lines if ln.startswith(f"{tag} served")]
        assert len(served) == 1, tag
    assert any("{'ec_group_rmatmul': 3, 'stencil_denoise': 3} (expected "
               "ec_group_rmatmul 3" in ln for ln in lines)
    assert any("a decode step: {'ec_rmatmul': 37, 'stencil_denoise': 21}"
               in ln for ln in lines)
