"""rwkv6 at depth: the port held to the reference on rwkv6-1.6b at d_model
512 (d_ff 1,792, heads of 64, vocab 4,096, float32, weights from seed 0)
at 2 layers and at its published 24, on two sequences of 32 tokens.

Random-init rwkv6 amplifies a perturbation of about one float32 ulp: a
relative nudge of 1e-7 to the embedding table moves the last token's
logits by some 1e-5 at 2 layers and some 1e-4 at 24.  The reference does
so too, which is what these tests show: each package's response to the
same nudges, the distance of each package's DAC-off logits (on the
reference's image, cells of 128^2) from its own digital ones, and the
distance between the packages, all on the last token's logits as
``chip_smoke.py`` reads them.  At 2 layers the packages agree within the
reduced configs' bound; at 24 they are held to FACTOR times what the
nudges move the reference itself.  Inputs are made with numpy from fixed
seeds."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_families import make_batch, np_tree
from _torch_port import few_threads, rel  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.configs import model_module as jmodel_module
from repro.configs.base import RRAMBackendConfig as JRRAM
from repro.models import common as jc
from repro.models import params as jPM
from repro.models import rram as jrram
from repro.models import transformer as jtf
from repro_torch.configs import get_arch, model_module
from repro_torch.configs.base import RRAMBackendConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import common as pc
from repro_torch.models import transformer as ptf

ARCH = "rwkv6-1.6b"
WIDTHS = {"d_model": 512, "d_ff": 1792, "vocab": 4096, "n_heads": 8,
          "n_kv_heads": 8, "d_head": 64, "ssm_head_dim": 64,
          "ssm_state": 64, "param_dtype": "float32",
          "compute_dtype": "float32"}
DEPTHS = (2, 24)
TOL = 1e-5              # the reduced configs' parity bound
NUDGE = 1e-7            # the embedding table times (1 + NUDGE * eta)
NUDGE_SEEDS = (84, 85, 86)
FACTOR = 4
RRAM_KW = {"enabled": True, "cell_rows": 128, "cell_cols": 128,
           "dw_dtype": "float32", "encode_inputs": False}


def run_depth(n_layers):
    """Last-token logits of both packages at ``n_layers``: digital, under
    each nudge, and (at the published depth) DAC off on the reference's
    image."""
    jcfg = dataclasses.replace(jget_arch(ARCH).model, n_layers=n_layers,
                               **WIDTHS)
    cfg = dataclasses.replace(get_arch(ARCH).model, n_layers=n_layers,
                              **WIDTHS)
    jmod, mod = jmodel_module(jcfg), model_module(cfg)
    tokens = make_batch(cfg, 2, 32, 83)["tokens"]

    def jlogits(p, rt=None):
        rt = rt or jc.Runtime()
        return np.asarray(jtf.logits_fn(
            p, jmod.forward(p, tokens, jcfg, rt)[0], jcfg, rt)[:, -1])

    def plogits(p, rt=None):
        rt = rt or pc.Runtime()
        with torch.no_grad():
            return ptf.logits_fn(p, mod.forward(
                p, torch.from_numpy(tokens), cfg, rt)[0], cfg, rt)[:, -1]

    jp = jax.jit(lambda k: jPM.materialize(jmod.init_specs(jcfg), k))(
        jax.random.PRNGKey(0))
    p = params_from_numpy(np_tree(jp), "cpu")
    out = {"reference": {"digital": jlogits(jp), "nudged": []},
           "port": {"digital": plogits(p), "nudged": []}}
    for seed in NUDGE_SEEDS:
        eta = np.random.default_rng(seed).standard_normal(
            jp["embed"].shape).astype(np.float32)
        out["reference"]["nudged"].append(
            jlogits(dict(jp, embed=jp["embed"] * (1 + NUDGE * eta))))
        out["port"]["nudged"].append(plogits(dict(
            p, embed=p["embed"] * (1 + NUDGE * torch.from_numpy(eta)))))
    if n_layers == jget_arch(ARCH).model.n_layers:
        jr = JRRAM(**RRAM_KW)
        jprog = jax.jit(lambda prm: jrram.program_rram(
            prm, jr, jax.random.PRNGKey(7))[0])(jp)
        out["reference"]["off"] = jlogits(
            jprog, jc.Runtime(rram=jr, key=jax.random.PRNGKey(9)))
        out["port"]["off"] = plogits(
            params_from_numpy(np_tree(jprog), "cpu"),
            pc.Runtime(rram=RRAMBackendConfig(**RRAM_KW), key=9))
    return out


@pytest.fixture(scope="module")
def runs():
    return {n: run_depth(n) for n in DEPTHS}


def response(run):
    """The most that the nudges move a package's digital logits."""
    return max(rel(m, run["digital"]) for m in run["nudged"])


def test_the_published_depth_is_the_probes():
    assert DEPTHS[-1] == jget_arch(ARCH).model.n_layers \
        == get_arch(ARCH).model.n_layers


@pytest.mark.parametrize("package", ["reference", "port"])
def test_a_nudge_grows_with_depth(runs, package):
    """Each package, by itself: at 24 layers the nudges move the logits
    over a hundred times their own size, and over five times what they
    move them at 2 layers."""
    shallow, deep = (response(runs[n][package]) for n in DEPTHS)
    assert deep >= 100 * NUDGE
    assert deep >= 5 * shallow


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_the_port_responds_as_the_reference_does(runs, n_layers):
    ref, port = (response(runs[n_layers][k]) for k in ("reference", "port"))
    assert ref / FACTOR <= port <= FACTOR * ref


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_the_packages_agree_within_the_references_own_response(
        runs, n_layers):
    """At 2 layers within TOL; at 24 within FACTOR times what the nudges
    move the reference."""
    run = runs[n_layers]
    got = rel(run["port"]["digital"], run["reference"]["digital"])
    bound = TOL if n_layers == DEPTHS[0] else FACTOR * response(
        run["reference"])
    assert got <= bound


def test_dac_off_moves_both_packages_alike_at_depth(runs):
    """DAC off on the reference's image against each package's own
    digital logits: both over a hundred nudges (the image's float32
    error amplified as a nudge is), within FACTOR of each other; and the
    packages' DAC-off logits within FACTOR times the reference's response
    of each other."""
    run = runs[DEPTHS[-1]]
    ref, port = (rel(run[k]["off"], run[k]["digital"])
                 for k in ("reference", "port"))
    assert ref >= 100 * NUDGE and port >= 100 * NUDGE
    assert ref / FACTOR <= port <= FACTOR * ref
    assert rel(run["port"]["off"], run["reference"]["off"]) <= \
        FACTOR * response(run["reference"])
