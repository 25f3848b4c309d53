"""The port's MoE layer held to the JAX package's (``repro.models.moe``):
``_capacity``, the sort-based dispatch and combine of ``_moe_ffn_chunk``
(with a capacity drop), the chunked path, the Switch aux term, the EC
``expert_mm`` of a single layer's MoE tree programmed on its own (digital,
DAC off, with the reference's DAC draws injected, without EC, at lam 1e-2),
``moe_apply`` on that tree, and ``program_rram`` on every family of this
slice (the same leaves programmed, the same images and ``WriteStats``).
Inputs are made with numpy from fixed seeds; the reference's parameters
are carried across with ``params_from_numpy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (DacDraws, few_threads,  # noqa: F401
                         rel, rng_array, rram_program_etas, to_np)
from repro.configs import get_arch as jget_arch
from repro.configs import model_module as jmodel_module
from repro.configs.base import RRAMBackendConfig as JRRAM
from repro.models import common as jc
from repro.models import moe as jmoe
from repro.models import params as jPM
from repro.models import rram as jrram
from repro_torch.configs import get_arch
from repro_torch.configs.base import RRAMBackendConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import common as pc
from repro_torch.models import moe as pmoe
from repro_torch.models import params as pPM
from repro_torch.models import rram as prram

TOL = 1e-5
MOE_ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
FAMILY_ARCHS = MOE_ARCHS + ["whisper-tiny", "llama-3.2-vision-11b"]
JKEY, PKEY = jax.random.PRNGKey(5), 5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rram_cfgs(**kw):
    kw = {"enabled": True, "cell_rows": 32, "cell_cols": 32, **kw}
    return JRRAM(**kw), RRAMBackendConfig(**kw)


def cfgs(name, **kw):
    return (dataclasses.replace(jget_arch(name).reduced(), **kw),
            dataclasses.replace(get_arch(name).reduced(), **kw))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def layer(request):
    """One layer's MoE tree (router (D, E), stacks (E, D, F) / (E, F, D)):
    (name, reference params, port params)."""
    jcfg, _ = cfgs(request.param)
    jp = jPM.materialize(jmoe.moe_specs(jcfg), jax.random.PRNGKey(1))
    return request.param, jp, params_from_numpy(np_tree(jp), "cpu")


@pytest.fixture(scope="module")
def programmed_layer(layer):
    """That tree programmed on its own by the reference (cells of 32^2):
    its expert stacks are 3-D, so each expert gets an image."""
    name, jp, _ = layer
    out = {}
    for dw_dtype in ("bfloat16", "float32"):
        jr, _ = rram_cfgs(dw_dtype=dw_dtype)
        jprog, _ = jrram.program_rram(jp, jr, jax.random.PRNGKey(7))
        out[dw_dtype] = jprog, params_from_numpy(np_tree(jprog), "cpu")
    return out


def routing(jp, p, x, cfg):
    """Top-k expert ids of both packages' fp32 gates, and each token's
    margin between its k-th and (k+1)-th gate (a near tie explains a
    flip)."""
    k = cfg.experts_per_token
    jg = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"], axis=-1)
    _, jidx = jax.lax.top_k(jg, k)
    pg = torch.softmax(torch.from_numpy(x) @ p["router"]["w"], dim=-1)
    _, pidx = torch.topk(pg, k, dim=-1)
    srt = np.sort(np.asarray(jg), axis=-1)[:, ::-1]
    return np.asarray(jidx), to_np(pidx), srt[:, k - 1] - srt[:, k]


def assert_same_routing(jp, p, x, cfg):
    jidx, pidx, margin = routing(jp, p, x, cfg)
    print(f"routing margin between gate k and k+1: min {margin.min():.3e}")
    assert np.array_equal(jidx, pidx), \
        f"routing differs; the smallest margin is {margin.min():.3e}"
    return jidx


# ----------------------------------------------------------------- capacity
@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("factor", [0.5, 1.25, 2.0])
def test_capacity_matches(name, factor):
    for full in (False, True):
        jcfg = jget_arch(name).model if full else jget_arch(name).reduced()
        cfg = get_arch(name).model if full else get_arch(name).reduced()
        jcfg = dataclasses.replace(jcfg, expert_capacity_factor=factor)
        cfg = dataclasses.replace(cfg, expert_capacity_factor=factor)
        for n in (1, 4, 7, 24, 64, 256, 1000, 8192):
            c = pmoe._capacity(n, cfg)
            assert c == jmoe._capacity(n, jcfg) and c % 8 == 0 and c >= 8
    assert pmoe.MOE_TOKEN_CHUNK == jmoe.MOE_TOKEN_CHUNK


def test_interop_carries_the_stacked_expert_kernels():
    """``params_from_numpy`` carries a model's 4-D ``(L, E, D, F)`` expert
    stacks across unchanged, in float32 and in bfloat16."""
    jcfg, _ = cfgs("mixtral-8x7b")
    specs = jmoe.init_specs(jcfg)
    for dtype in (jnp.float32, jnp.bfloat16):
        jp = jPM.materialize(specs, jax.random.PRNGKey(2), dtype)
        p = params_from_numpy(np_tree(jp), "cpu")
        for name in ("wg", "wu", "wd"):
            a, b = p["layers"]["moe"][name]["w"], jp["layers"]["moe"][name]["w"]
            assert a.ndim == 4 and tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            assert np.array_equal(to_np(a.to(torch.float32)),
                                  np.asarray(b.astype(jnp.float32)))


# --------------------------------------------------------- dispatch/combine
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_dispatch_and_combine_match(layer, factor):
    """``_moe_ffn_chunk`` on 24 tokens: the routing first (equal ids), then
    the output and the aux term.  At capacity factor 0.5 some expert gets
    more assignments than its capacity, so tokens are dropped."""
    name, jp, p = layer
    jcfg, cfg = cfgs(name, expert_capacity_factor=factor)
    x = rng_array((24, cfg.d_model), 3)
    idx = assert_same_routing(jp, p, x, cfg)
    counts = np.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    cap = pmoe._capacity(24, cfg)
    assert (counts.max() > cap) == (factor == 0.5), (counts, cap)
    want, waux = jmoe._moe_ffn_chunk(jp, x, jcfg, None)
    got, gaux = pmoe._moe_ffn_chunk(p, torch.from_numpy(x), cfg, None)
    assert got.shape == want.shape and rel(got, want) <= TOL
    assert rel(gaux, waux) <= TOL
    # The aux term is E * sum_e f_e * P_e on these ids and gates.
    gates = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"]))
    f_e = counts / idx.size
    assert float(gaux) == pytest.approx(
        cfg.n_experts * float(np.sum(f_e * gates.mean(0))), rel=1e-5)
    # The drop shows: with room for every assignment the output moves.
    if factor == 0.5:
        full, _ = pmoe._moe_ffn_chunk(
            p, torch.from_numpy(x),
            dataclasses.replace(cfg, expert_capacity_factor=4.0), None)
        assert rel(got, full) > 1e-3


def test_chunked_path_matches(layer, monkeypatch):
    """With ``MOE_TOKEN_CHUNK`` at 8 on both modules, 32 tokens run as 4
    chunks (each with its own capacity), the aux the chunks' mean; 30
    tokens (not a multiple) run whole."""
    name, jp, p = layer
    jcfg, cfg = cfgs(name)
    monkeypatch.setattr(jmoe, "MOE_TOKEN_CHUNK", 8)
    monkeypatch.setattr(pmoe, "MOE_TOKEN_CHUNK", 8)
    for n in (32, 30):
        x = rng_array((n, cfg.d_model), 4)
        assert_same_routing(jp, p, x, cfg)
        want, waux = jmoe._moe_ffn_local(jp, x, jcfg, None)
        got, gaux = pmoe._moe_ffn_local(p, torch.from_numpy(x), cfg, None)
        assert rel(got, want) <= TOL and rel(gaux, waux) <= TOL
    chunks = [pmoe._moe_ffn_chunk(p, c, cfg, None)
              for c in torch.from_numpy(rng_array((32, cfg.d_model), 4))
              .split(8)]
    got, gaux = pmoe._moe_ffn_local(
        p, torch.from_numpy(rng_array((32, cfg.d_model), 4)), cfg, None)
    assert torch.equal(got, torch.cat([c[0] for c in chunks]))
    assert torch.equal(gaux, torch.stack([c[1] for c in chunks]).mean())


def test_moe_apply_and_aux_in_the_loss(layer):
    """``moe_apply`` on (B, T, D), and the model's loss with its aux
    weight, against the reference."""
    name, jp, p = layer
    jcfg, cfg = cfgs(name)
    x = rng_array((2, 5, cfg.d_model), 5)
    want, waux = jmoe.moe_apply(jp, x, jcfg, None)
    got, gaux = pmoe.moe_apply(p, torch.from_numpy(x), cfg, None)
    assert got.shape == (2, 5, cfg.d_model)
    assert rel(got, want) <= TOL and rel(gaux, waux) <= TOL
    jparams = jPM.materialize(jmoe.init_specs(jcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(np_tree(jparams), "cpu")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 6)) \
        .astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, jaux = jmoe.forward(jparams, tokens, jcfg, jc.Runtime())
    _, _, aux = pmoe.forward(params, pbatch["tokens"], cfg, pc.Runtime())
    assert rel(aux, jaux) <= TOL and float(aux) > 0
    for w in (0.01, 2.0):
        assert rel(pmoe.loss(params, pbatch, cfg, pc.Runtime(), w),
                   jmoe.loss(jparams, batch, jcfg, jc.Runtime(), w)) <= TOL


# ----------------------------------------------------------- the expert EC
@pytest.mark.parametrize("dw_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["digital", "dac_off", "dac_on", "no_ec",
                                  "lam"])
def test_expert_mm_matches(layer, programmed_layer, mode, dw_dtype):
    """``expert_mm`` on a programmed (E, D, F) stack against the
    reference's ``_expert_mm``, at 12 capacity slots (two 8-column launches
    a member on the card); ``lam`` at 1e-2 so the tier-2 step along F shows
    in fp32.  The plain twin is the same on the CPU; DAC off is near the
    digital product."""
    name, jp_digital, p_digital = layer
    jprog, prog = programmed_layer[dw_dtype]
    jcfg, cfg = cfgs(name)
    x = rng_array((cfg.n_experts, 12, cfg.d_model), 7)
    kw = {"dw_dtype": dw_dtype, "encode_inputs": mode != "dac_off",
          "ec": mode != "no_ec", "lam": 1e-2 if mode == "lam" else 1e-12}
    jr, pr = rram_cfgs(**kw)
    for stack in ("wg", "wd"):
        xs = x if stack == "wg" else \
            rng_array((cfg.n_experts, 12, cfg.d_ff), 8)
        if mode == "digital":
            want = jmoe._expert_mm(jp_digital[stack], xs, None)
            got = pmoe.expert_mm(p_digital[stack], torch.from_numpy(xs), None)
            assert rel(got, want) <= TOL
            continue
        jrt = jc.Runtime(rram=jr, key=JKEY)
        rt = pc.Runtime(rram=pr, key=PKEY, draw=DacDraws(JKEY, PKEY))
        want = jmoe._expert_mm(jprog[stack], xs, jrt)
        got = pmoe.expert_mm(prog[stack], torch.from_numpy(xs), rt)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert rel(got, want) <= TOL, stack
        keyed = int(mode != "dac_off")       # DAC off draws no key
        assert rt._salt == jrt._salt == keyed
        assert rt.draw.calls == [(None, 1)] * keyed
        twin = pmoe.expert_mm_plain(
            prog[stack], torch.from_numpy(xs),
            pc.Runtime(rram=pr, key=PKEY, draw=DacDraws(JKEY, PKEY)))
        assert torch.equal(got, twin)
        if mode == "dac_off":
            digital = np.einsum("ecd,edf->ecf", xs,
                                np.asarray(jp_digital[stack]["w"]))
            assert rel(got, digital) < 0.1


def test_moe_apply_on_the_programmed_layer(layer, programmed_layer,
                                           monkeypatch):
    """``moe_apply`` on the programmed tree with the reference's DAC draws:
    the expert stacks take salts 1, 2, 3 (wg, wu, wd; the router is read
    digitally although it is programmed).  Chunked (``MOE_TOKEN_CHUNK`` 8,
    32 tokens), the reference's ``lax.map`` traces its body once, so every
    chunk takes the same three salts, recorded under ``jit``."""
    name, _, _ = layer
    jprog, prog = programmed_layer["float32"]
    jcfg, cfg = cfgs(name)
    jr, pr = rram_cfgs(dw_dtype="float32")
    assert "w_tilde" in prog["router"] and "w_tilde" in prog["wg"]
    for n_tok, chunk in ((6, 8192), (32, 8)):
        monkeypatch.setattr(jmoe, "MOE_TOKEN_CHUNK", chunk)
        monkeypatch.setattr(pmoe, "MOE_TOKEN_CHUNK", chunk)
        x = rng_array((1, n_tok, cfg.d_model), 9)
        assert_same_routing(jprog, prog, x[0], cfg)
        seen = []
        real = jc._encode_act
        monkeypatch.setattr(jc, "_encode_act",
                            lambda x_, key, c: seen.append(x_.shape) or
                            real(x_, key, c))
        jrt = jc.Runtime(rram=jr, key=JKEY)
        want, waux = jax.jit(
            lambda prm, xx: jmoe.moe_apply(prm, xx, jcfg, jrt))(jprog, x)
        monkeypatch.setattr(jc, "_encode_act", real)
        assert len(seen) == 3 and jrt._salt == 3
        rt = pc.Runtime(rram=pr, key=PKEY, draw=DacDraws(JKEY, PKEY))
        got, gaux = pmoe.moe_apply(prog, torch.from_numpy(x), cfg, rt)
        assert rel(got, want) <= TOL and rel(gaux, waux) <= TOL
        n_chunks = n_tok // chunk if n_tok > chunk else 1
        assert rt.draw.calls == [(None, s) for s in (1, 2, 3)] * n_chunks
        assert rt._salt == 3


# ------------------------------------------------------------- programming
@pytest.mark.parametrize("name", FAMILY_ARCHS + ["moe-layer"])
def test_program_rram_programs_the_references_leaves(name):
    """With the reference's programming draws injected, the port programs
    the leaves the reference programs -- a model's 4-D (L, E, D, F) expert
    stacks and llama-vision's 4-D self layers stay digital, the MoE router
    and 3-D stacks are programmed (per-expert keys on a single layer's
    tree) -- with the same images and ``WriteStats`` (grouped billing)."""
    arch = "mixtral-8x7b" if name == "moe-layer" else name
    jcfg, cfg = cfgs(arch)
    if name == "moe-layer":
        jspecs = jmoe.moe_specs(jcfg)
    else:
        jspecs = jmodel_module(jcfg).init_specs(jcfg)
    jparams = jPM.materialize(jspecs, jax.random.PRNGKey(0))
    params = params_from_numpy(np_tree(jparams), "cpu")
    jr, pr = rram_cfgs(dw_dtype="float32")
    key = jax.random.PRNGKey(7)
    eta = rram_program_etas(jparams, jrram.crossbar_cfg(jr), key)
    jprog, jstats = jrram.program_rram(jparams, jr, key)
    prog, stats = prram.program_rram(params, pr, 123, eta=eta)
    got, want = pPM.tree_paths(prog), jPM.tree_paths(jprog)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert rel(a, np.asarray(b)) <= 1e-6, path
    programmed = [p for p, _ in got if p.endswith("['w_tilde']")]
    kernels = [p for p, a in got if p.endswith("['w']")]
    for path in kernels:
        ndim = dict(got)[path].ndim
        assert (path.replace("['w']", "['w_tilde']") in programmed) == \
            (ndim in (2, 3)), path
    if name in MOE_ARCHS + ["moe-layer"]:
        assert any("['router']" in p for p in programmed)
    if name in MOE_ARCHS:
        assert not any(s in p for p in programmed
                       for s in ("['wg']", "['wu']", "['wd']"))
    for f in ("energy_j", "latency_s", "final_delta"):
        assert getattr(stats, f) == pytest.approx(float(getattr(jstats, f)),
                                                  rel=1e-6), f
    assert stats.iterations == int(jstats.iterations)
    assert prram.programming_dispatch_plan(params) == \
        jrram.programming_dispatch_plan(jparams)
    assert prram.programmed_kernel_shapes(prog) == \
        jrram.programmed_kernel_shapes(jprog)
    if name == "moe-layer":
        assert prog["wg"]["w_tilde"].shape == (cfg.n_experts, cfg.d_model,
                                               cfg.d_ff)
    if name == "llama-3.2-vision-11b":
        assert "w_tilde" not in prog["super"]["self"]["attn"]["wq"]
        assert "w_tilde" in prog["super"]["cross"]["attn"]["wk"]
