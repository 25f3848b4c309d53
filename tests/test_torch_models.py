"""The port's transformer modules held to the JAX package's: configs,
parameter specs, norms, RoPE, MLPs, the loss, attention in every cache
mode, the chunked flash attention, the analog ``dense`` (digital, DAC off
and with the reference's DAC draws injected; dw in bfloat16 and float32),
``program_rram`` with the reference's programming draws injected and its
helpers, and ``forward`` / ``loss`` on reduced qwen3-1.7b, yi-9b and
nemotron-4-15b.  Inputs are made with numpy from fixed seeds; the
reference's parameters are carried across with ``params_from_numpy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (DacDraws, few_threads,  # noqa: F401
                         rel, rng_array, rram_program_etas, to_np)
from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.configs import model_module as jmodel_module
from repro.configs.base import RRAMBackendConfig as JRRAM
from repro.models import common as jc
from repro.models import flash as jflash
from repro.models import params as jPM
from repro.models import rram as jrram
from repro.models import transformer as jtf
from repro_torch.configs import ARCHS, get_arch, model_module
from repro_torch.configs.base import RRAMBackendConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import common as pc
from repro_torch.models import flash as pflash
from repro_torch.models import params as pPM
from repro_torch.models import rram as prram
from repro_torch.models import transformer as ptf

TOL = 1e-5
ELEM_TOL = 1e-6
MODEL_ARCHS = ["qwen3-1.7b", "yi-9b", "nemotron-4-15b"]
JKEY, PKEY = jax.random.PRNGKey(5), 5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tree_rel(got, want):
    """Worst rel-L2 over the leaves of two trees with the same paths."""
    g, w = pPM.tree_paths(got), jPM.tree_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    return max(rel(to_np(a).astype(np.float32),
                   np.asarray(jnp.asarray(b, jnp.float32)))
               for (_, a), (_, b) in zip(g, w))


def rram_cfgs(**kw):
    kw = {"enabled": True, "cell_rows": 32, "cell_cols": 32, **kw}
    return JRRAM(**kw), RRAMBackendConfig(**kw)


@pytest.fixture(scope="module", params=MODEL_ARCHS)
def model(request):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = jget_arch(request.param).reduced()
    cfg = get_arch(request.param).reduced()
    jparams = jPM.materialize(jtf.init_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_numpy(np_tree(jparams), "cpu")


@pytest.fixture(scope="module")
def programmed(model):
    """The reference's programmed tree (cells of 32^2) on both sides."""
    jcfg, cfg, jparams, _ = model
    jr, _ = rram_cfgs()
    jprog, _ = jrram.program_rram(jparams, jr, jax.random.PRNGKey(7))
    return jprog, params_from_numpy(np_tree(jprog), "cpu")


# ------------------------------------------------------------------ configs
def test_configs_are_copies_of_the_reference():
    assert ARCHS == JARCHS
    for name in ARCHS + ("meliso-mvm",):
        assert dataclasses.asdict(get_arch(name)) == \
            dataclasses.asdict(jget_arch(name)), name
        assert dataclasses.asdict(get_arch(name).reduced()) == \
            dataclasses.asdict(jget_arch(name).reduced()), name
    assert dataclasses.asdict(RRAMBackendConfig()) == \
        dataclasses.asdict(JRRAM())


@pytest.mark.parametrize("name", ["meliso-mvm", "no-such-family"])
def test_model_module_names_the_missing_family(name):
    """A family without a model module, named or not: ``KeyError``, as the
    reference's dict lookup raises."""
    if name == "no-such-family":
        cfg = dataclasses.replace(get_arch("qwen3-1.7b").model, family=name)
    else:
        cfg = get_arch(name).model
    with pytest.raises(KeyError, match=cfg.family):
        model_module(cfg)
    with pytest.raises(KeyError, match=cfg.family):
        jmodel_module(cfg)


@pytest.mark.parametrize("name,module", [
    ("mixtral-8x7b", "moe"), ("phi3.5-moe-42b-a6.6b", "moe"),
    ("whisper-tiny", "whisper"), ("llama-3.2-vision-11b", "llama_vision"),
    ("rwkv6-1.6b", "rwkv6"), ("zamba2-1.2b", "zamba2")])
def test_model_module_maps_the_attention_families(name, module):
    """The families ported after the transformer (moved here from the
    missing-family cases), the recurrent ones included."""
    import importlib
    assert model_module(get_arch(name).model) is \
        importlib.import_module(f"repro_torch.models.{module}")
    assert model_module(get_arch(name).reduced()).__name__ == \
        f"repro_torch.models.{module}"


def test_model_module_maps_the_transformer_family():
    for name in MODEL_ARCHS + ["qwen3-8b"]:
        assert model_module(get_arch(name).model) is ptf
    with pytest.raises(KeyError):
        get_arch("gpt-5")


# ------------------------------------------------------------------- params
def test_materialize_paths_shapes_dtypes_and_bounds(model):
    jcfg, cfg, jparams, _ = model
    params = pPM.materialize(ptf.init_specs(cfg), 0, device="cpu")
    got, want = pPM.tree_paths(params), jPM.tree_paths(jparams)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, path
    # Every dict comes out with sorted keys (jax.tree.unflatten's order).
    def sorted_keys(t):
        return not isinstance(t, dict) or (
            list(t) == sorted(t) and all(map(sorted_keys, t.values())))
    assert sorted_keys(params)
    specs = dict(pPM.tree_paths(ptf.init_specs(cfg)))
    for path, a in got:
        s = specs[path]
        if s.init == "ones":
            assert bool((a == 1).all()), path
        elif s.init == "embed":
            assert abs(float(a.std()) - 0.02) < 2e-3, path
        elif s.init == "normal":
            fan_in = s.shape[-2]
            assert float(a.abs().max()) < 2.0 / np.sqrt(fan_in), path
            assert abs(float(a.std()) * np.sqrt(fan_in) - 0.88) < 0.05, path
    again = pPM.materialize(ptf.init_specs(cfg), 0, device="cpu")
    other = pPM.materialize(ptf.init_specs(cfg), 1, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(got, pPM.tree_paths(again)))
    assert not torch.equal(params["lm_head"]["w"], other["lm_head"]["w"])


def test_abstract_axes_and_stacked_specs(model):
    jcfg, cfg, _, _ = model
    specs, jspecs = ptf.init_specs(cfg), jtf.init_specs(jcfg)
    absd = pPM.tree_paths(pPM.abstract(specs, torch.bfloat16))
    jabs = jPM.tree_paths(jPM.abstract(jspecs, jnp.bfloat16))
    assert [(p, a.shape, str(a.dtype).split(".")[-1]) for p, a in absd] == \
        [(p, b.shape, str(b.dtype)) for p, b in jabs]
    got = pPM.tree_paths(pPM.logical_axes(specs))
    want = jax.tree_util.tree_flatten_with_path(
        jPM.logical_axes(jspecs), is_leaf=lambda x: isinstance(x, tuple))[0]
    assert [(p, a) for p, a in got] == \
        [(jax.tree_util.keystr(p), a) for p, a in want]


# ------------------------------------------------------ norms, rope, mlp, CE
def test_norms_rope_and_positions():
    x = rng_array((2, 5, 4, 16), 0)
    scale = rng_array((16,), 1)
    bias = rng_array((16,), 2)
    assert rel(pc.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x), 1e-6),
               jc.rmsnorm({"scale": scale}, x, 1e-6)) <= ELEM_TOL
    assert rel(pc.layernorm({"scale": torch.from_numpy(scale),
                             "bias": torch.from_numpy(bias)},
                            torch.from_numpy(x), 1e-5),
               jc.layernorm({"scale": scale, "bias": bias}, x, 1e-5)) \
        <= ELEM_TOL
    pos = np.arange(3, 8, dtype=np.int32)[None, :].repeat(2, 0)
    for theta in (1e4, 1e6):
        assert rel(pc.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
                   jc.rope(x, pos, theta)) <= ELEM_TOL
    assert rel(pc.sinusoidal_positions(40, 24),
               jc.sinusoidal_positions(40, 24)) <= ELEM_TOL


@pytest.mark.parametrize("act", ["silu_gated", "sq_relu", "gelu"])
def test_mlp_matches(act):
    cfg = dataclasses.replace(get_arch("qwen3-1.7b").reduced(), act=act)
    jcfg = dataclasses.replace(jget_arch("qwen3-1.7b").reduced(), act=act)
    jp = jPM.materialize(jc.mlp_specs(jcfg), jax.random.PRNGKey(3))
    p = params_from_numpy(np_tree(jp), "cpu")
    x = rng_array((2, 3, cfg.d_model), 4)
    assert rel(pc.mlp(p, torch.from_numpy(x), cfg),
               jc.mlp(jp, x, jcfg)) <= ELEM_TOL


def test_cross_entropy_loss_matches():
    logits = rng_array((3, 7, 50), 5, scale=3.0)
    labels = np.random.default_rng(6).integers(-1, 50, (3, 7)) \
        .astype(np.int32)
    assert rel(pc.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels)),
               jc.cross_entropy_loss(logits, labels)) <= ELEM_TOL


# ---------------------------------------------------------------- attention
def attn_setup(swa=None, qk_norm=True):
    kw = {"swa_window": swa, "qk_norm": qk_norm}
    cfg = dataclasses.replace(get_arch("qwen3-1.7b").reduced(), **kw)
    jcfg = dataclasses.replace(jget_arch("qwen3-1.7b").reduced(), **kw)
    jp = jPM.materialize(jc.attention_specs(jcfg), jax.random.PRNGKey(8))
    return cfg, jcfg, jp, params_from_numpy(np_tree(jp), "cpu")


def cache_pair(jcfg, b, max_len, fill, seed):
    """The same cache on both sides, its first ``fill`` slots filled."""
    k = np.zeros((b, max_len, jcfg.n_kv_heads, jcfg.d_head), np.float32)
    v = np.zeros_like(k)
    k[:, :fill] = rng_array((b, fill) + k.shape[2:], seed)
    v[:, :fill] = rng_array((b, fill) + k.shape[2:], seed + 1)
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v),
              "len": jnp.asarray(fill, jnp.int32)}
    pcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "len": torch.tensor(fill, dtype=torch.int32)}
    return jcache, pcache


@pytest.mark.parametrize("mode", ["full", "prefill", "decode", "cross",
                                  "swa_prefill", "swa_decode"])
def test_attention_cache_modes(mode):
    """No cache, the append cache (prefill and decode), cross-attention,
    and the circular sliding-window cache (prefill roll, decode slot)."""
    swa = 6 if mode.startswith("swa") else None
    cfg, jcfg, jp, p = attn_setup(swa)
    b = 2
    t = {"full": 9, "prefill": 9, "decode": 1, "cross": 5,
         "swa_prefill": 9, "swa_decode": 1}[mode]
    x = rng_array((b, t, cfg.d_model), 10)
    kw, pkw = {}, {}
    if mode == "cross":
        src = rng_array((b, 7, cfg.d_model), 11)
        kw["kv_x"], pkw["kv_x"] = src, torch.from_numpy(src)
    if mode in ("prefill", "decode", "swa_prefill", "swa_decode"):
        max_len = 6 if swa else 16
        fill = {"prefill": 0, "decode": 11, "swa_prefill": 0,
                "swa_decode": 8}[mode]
        kw["cache"], pkw["cache"] = cache_pair(jcfg, b, max_len,
                                               min(fill, max_len), 12)
        if mode.endswith("decode"):
            # The circular cache holds 8 tokens' worth of history in 6 slots.
            kw["cache"]["len"] = jnp.asarray(fill, jnp.int32)
            pkw["cache"]["len"] = torch.tensor(fill, dtype=torch.int32)
            pos = np.full((b, 1), fill, np.int32)
            kw["positions"], pkw["positions"] = pos, torch.from_numpy(pos)
    want, wcache = jc.attention(jp, x, jcfg, None, **kw)
    got, gcache = pc.attention(p, torch.from_numpy(x), cfg, None, **pkw)
    assert rel(got, want) <= TOL
    if wcache is not None:
        assert int(gcache["len"]) == int(wcache["len"])
        assert rel(gcache["k"], wcache["k"]) <= TOL
        assert rel(gcache["v"], wcache["v"]) <= TOL


@pytest.mark.parametrize("case", ["causal", "window", "valid", "skip",
                                  "skip_window", "nomask"])
def test_flash_attention_matches(case):
    b, t, kv, g, dh = 2, 16, 2, 2, 8
    qg = rng_array((b, t, kv, g, dh), 20)
    k, v = rng_array((b, t, kv, dh), 21), rng_array((b, t, kv, dh), 22)
    q_pos = np.arange(t, dtype=np.int32)[None].repeat(b, 0)
    valid = None
    if case == "valid":
        valid = np.random.default_rng(23).random((b, t)) > 0.3
        valid[:, 0] = True
    kw = {"causal": case != "nomask",
          "window": 5 if "window" in case else None,
          "q_chunk": 4, "kv_chunk": 4,
          "causal_skip": case.startswith("skip")}
    want = jflash.flash_attention(qg, k, v, q_pos, q_pos, valid, **kw)
    got = pflash.flash_attention(
        torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), torch.from_numpy(q_pos),
        None if valid is None else torch.from_numpy(valid), **kw)
    assert rel(got, want) <= TOL


def test_attention_takes_flash_above_the_threshold():
    """With t * s over ``flash_threshold`` both packages chunk; the result
    is the unchunked attention's to fp32 rounding."""
    cfg, jcfg, jp, p = attn_setup()
    x = rng_array((1, 16, cfg.d_model), 30)
    jrt = jc.Runtime(flash_threshold=64, q_chunk=4, kv_chunk=8)
    rt = pc.Runtime(flash_threshold=64, q_chunk=4, kv_chunk=8)
    want, _ = jc.attention(jp, x, jcfg, jrt)
    got, _ = pc.attention(p, torch.from_numpy(x), cfg, rt)
    plain, _ = pc.attention(p, torch.from_numpy(x), cfg, None)
    assert rel(got, want) <= TOL and rel(got, plain) <= TOL
    with pytest.raises(ValueError, match="chunks"):
        pc.attention(p, torch.from_numpy(x), cfg,
                     pc.Runtime(flash_threshold=64, q_chunk=5))


# -------------------------------------------------------------------- dense
def analog_layer(d_in, d_out, dw_dtype, seed):
    w = rng_array((d_in, d_out), seed, scale=d_in ** -0.5)
    wt = (w * (1 + 0.05 * rng_array((d_in, d_out), seed + 1))) \
        .astype(np.float32)
    jdw = jnp.asarray(w - wt).astype(dw_dtype)
    jp = {"w": jnp.asarray(w), "w_tilde": jnp.asarray(wt), "dw": jdw}
    return jp, params_from_numpy(np_tree(jp), "cpu")


@pytest.mark.parametrize("dw_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["digital", "dac_off", "dac_on", "no_ec",
                                  "lam"])
def test_dense_matches(mode, dw_dtype):
    """At 3 x 5 = 15 rows (two kernel panels on the card); ``lam`` at 1e-2
    so that the tier-2 stencil (along d_out) shows in fp32."""
    jp, p = analog_layer(48, 40, dw_dtype, 40)
    x = rng_array((3, 5, 48), 42)
    kw = {"dw_dtype": dw_dtype, "encode_inputs": mode != "dac_off",
          "ec": mode != "no_ec", "lam": 1e-2 if mode == "lam" else 1e-12}
    jr, pr = rram_cfgs(**kw)
    if mode == "digital":
        jrt, rt = None, None
    else:
        jrt = jc.Runtime(rram=jr, key=JKEY)
        rt = pc.Runtime(rram=pr, key=PKEY, draw=DacDraws(JKEY, PKEY))
    want = jc.dense(jp, x, jrt)
    got = pc.dense(p, torch.from_numpy(x), rt)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel(got, want) <= TOL
    if mode in ("dac_on", "no_ec", "lam"):
        assert rt.draw.calls == [(None, 1)] and rt._salt == jrt._salt == 1


def test_dense_default_draws_are_the_ports_own():
    """Without a ``draw`` hook the DAC noise comes from the port's
    generator under the call's key: the same key draws the same x_tilde,
    another key another one; DAC off no draw at all.  ``dense_plain``
    takes the same draw (on the CPU it is ``dense`` itself)."""
    _, p = analog_layer(32, 24, "float32", 50)
    x = torch.from_numpy(rng_array((4, 32), 51))
    _, pr = rram_cfgs(dw_dtype="float32")
    a = pc.dense(p, x, pc.Runtime(rram=pr, key=1))
    b = pc.dense(p, x, pc.Runtime(rram=pr, key=1))
    c = pc.dense(p, x, pc.Runtime(rram=pr, key=2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, pc.dense_plain(p, x, pc.Runtime(rram=pr, key=1)))
    assert rel(a, x @ p["w"]) < 0.05


# ----------------------------------------------------------- program_rram
@pytest.mark.parametrize("dw_dtype", ["bfloat16", "float32"])
def test_program_rram_matches_with_injected_draws(model, dw_dtype):
    jcfg, cfg, jparams, params = model
    jr, pr = rram_cfgs(dw_dtype=dw_dtype)
    key = jax.random.PRNGKey(7)
    eta = rram_program_etas(jparams, jrram.crossbar_cfg(jr), key)
    results = {}
    for group in (True, False):
        jprog, jstats = jrram.program_rram(jparams, jr, key, group=group)
        prog, stats = prram.program_rram(params, pr, 123, group=group,
                                         eta=eta)
        got, want = pPM.tree_paths(prog), jPM.tree_paths(jprog)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            b = np.asarray(jnp.asarray(b, jnp.float32))
            a = to_np(a.to(torch.float32))
            if path.endswith("['dw']"):
                # dw is w - w_tilde rounded to dw_dtype on both sides: in
                # bfloat16 equal but where w_tilde's last bit moves a tie.
                if dw_dtype == "float32":
                    assert rel(a, b) <= ELEM_TOL, path
                else:
                    assert rel(a, b) <= 2.0 ** -8, path
                    assert np.mean(a == b) > 0.99, path
            else:
                assert rel(a, b) <= ELEM_TOL, path
        for f in ("energy_j", "latency_s", "final_delta"):
            assert getattr(stats, f) == pytest.approx(
                float(getattr(jstats, f)), rel=1e-6), f
        assert stats.iterations == int(jstats.iterations)
        results[group] = prog, stats
    (g_tree, g_stats), (s_tree, s_stats) = results[True], results[False]
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(pPM.tree_paths(g_tree), pPM.tree_paths(s_tree)))
    for f in ("energy_j", "latency_s", "final_delta"):
        assert getattr(g_stats, f) == pytest.approx(getattr(s_stats, f),
                                                    rel=1e-12), f


def test_program_rram_own_draws_and_helpers(model, programmed):
    jcfg, cfg, jparams, params = model
    jprog, prog_ref = programmed
    jr, pr = rram_cfgs()
    prog, stats = prram.program_rram(params, pr, 7)
    assert prram.is_programmed(prog) and not prram.is_programmed(params)
    assert prram.programming_dispatch_plan(prog) == \
        jrram.programming_dispatch_plan(jparams)
    assert pPM.tree_paths(prram.strip_rram(prog))[0][0] == "['embed']"
    assert [p for p, _ in pPM.tree_paths(prram.strip_rram(prog))] == \
        [p for p, _ in pPM.tree_paths(params)]
    again, _ = prram.program_rram(params, pr, 7)
    other, ostats = prram.reprogram_rram(prog, pr, 8)
    wt = prog["layers"]["attn"]["wq"]["w_tilde"]
    assert torch.equal(wt, again["layers"]["attn"]["wq"]["w_tilde"])
    assert not torch.equal(wt, other["layers"]["attn"]["wq"]["w_tilde"])
    assert ostats == stats
    # Same image statistics as the reference's own draws: a few % off w.
    w = params["layers"]["attn"]["wq"]["w"]
    jw = jprog["layers"]["attn"]["wq"]
    assert rel(wt, w) == pytest.approx(
        rel(np.asarray(jw["w_tilde"]), np.asarray(jw["w"])), rel=0.2)
    assert prram.analog_image_bytes(prog_ref) == \
        jrram.analog_image_bytes(jprog) == prram.analog_image_bytes(prog)
    assert prram.programmed_kernel_shapes(prog) == \
        jrram.programmed_kernel_shapes(jprog)
    for batch in (1, 6):
        got = prram.forward_input_stats(prog, pr, batch)
        want = jrram.forward_input_stats(jprog, jr, batch)
        assert got.energy_j == pytest.approx(float(want.energy_j), rel=1e-6)
        assert got.latency_s == pytest.approx(float(want.latency_s),
                                              rel=1e-6)
    got = pPM.tree_paths(prram.program_specs(ptf.init_specs(cfg), pr))
    want = jPM.tree_paths(jrram.program_specs(jtf.init_specs(jcfg), jr),
                          is_leaf=jPM.is_spec)
    assert [(p, s.shape, s.axes, s.init, s.dtype) for p, s in got] == \
        [(p, s.shape, s.axes, s.init, s.dtype) for p, s in want]
    with pytest.raises(ValueError, match="programming draws"):
        prram.program_rram(params, pr, 7, eta=[None])


# ------------------------------------------------------------ forward, loss
@pytest.mark.parametrize("mode", ["digital", "dac_off", "dac_on"])
def test_forward_and_loss_match(model, programmed, mode):
    jcfg, cfg, jparams, params = model
    tokens = np.random.default_rng(60).integers(0, cfg.vocab, (2, 7)) \
        .astype(np.int32)
    labels = np.random.default_rng(61).integers(-1, cfg.vocab, (2, 7)) \
        .astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mode == "digital":
        jp, p, jrt, rt = jparams, params, jc.Runtime(), pc.Runtime()
    else:
        jp, p = programmed
        jr, pr = rram_cfgs(encode_inputs=mode == "dac_on")
        jrt = jc.Runtime(rram=jr, key=JKEY)
        rt = pc.Runtime(rram=pr, key=PKEY, draw=DacDraws(JKEY, PKEY))
    want, _ = jtf.forward(jp, tokens, jcfg, jrt)
    got, _ = ptf.forward(p, pbatch["tokens"], cfg, rt)
    assert rel(got, want) <= TOL
    jrt._salt, rt._salt = 0, 0
    want = jtf.loss(jp, batch, jcfg, jrt)
    got = ptf.loss(p, pbatch, cfg, rt)
    assert rel(got, want) <= TOL
    if mode != "digital":
        assert rt._salt == jrt._salt


def test_layers_share_dac_keys_as_in_the_reference(model, programmed,
                                                   monkeypatch):
    """The reference scans its stacked layers, tracing the body once: its
    dense calls draw under 8 salts (7 a layer, shared by every layer, and
    the head's).  The port's loop takes the same keys call site by call
    site."""
    jcfg, cfg, _, _ = model
    jp, p = programmed
    jr, pr = rram_cfgs()
    n_body = 7 if cfg.act == "silu_gated" else 6
    seen = []
    real = jc._encode_act
    monkeypatch.setattr(jc, "_encode_act",
                        lambda x, key, c: seen.append(x.shape) or
                        real(x, key, c))
    tokens = np.arange(6, dtype=np.int32).reshape(1, 6)

    def run(params, key):
        rt = jc.Runtime(rram=jr, key=key)
        h, _ = jtf.forward(params, tokens, jcfg, rt)
        return jtf.logits_fn(params, h, jcfg, rt), rt._salt

    jax.jit(lambda prm, k: run(prm, k)[0])(jp, JKEY)
    assert len(seen) == n_body + 1
    draws = DacDraws(JKEY, PKEY)
    rt = pc.Runtime(rram=pr, key=PKEY, draw=draws)
    h, _ = ptf.forward(p, torch.from_numpy(tokens), cfg, rt)
    ptf.logits_fn(p, h, cfg, rt)
    body = [(None, s) for s in range(1, n_body + 1)]
    assert draws.calls == body * cfg.n_layers + [(None, n_body + 1)]
    assert rt._salt == n_body + 1
