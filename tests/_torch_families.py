"""Shared helpers of ``test_torch_families.py``,
``test_torch_families_serve.py`` and the recurrent families' two files:
the reduced archs of the families, their batches (tokens, and frames or
patches), each family's forward pass to the hidden states, runtimes with
the reference's DAC draws injected, and the salt sequence the reference's
scans hand out."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import DacDraws
from repro.configs import get_arch as jget_arch
from repro.configs import model_module as jmodel_module
from repro.configs.base import RRAMBackendConfig as JRRAM
from repro.models import common as jc
from repro.models import params as jPM
from repro.models import rram as jrram
from repro_torch.configs.base import RRAMBackendConfig
from repro_torch.models import common as pc

ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "whisper-tiny",
         "llama-3.2-vision-11b"]
MODES = ["digital", "dac_off", "dac_on"]
FRAMES = 10             # whisper's frames a request
GATE = 0.7              # llama-vision's cross gates (zero at init)
JKEY, PKEY = jax.random.PRNGKey(9), 9


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference_model(name, **kw):
    """The reference's reduced ``name`` (``kw`` replaced in its config):
    (cfg, module, digital params, params programmed under PRNGKey(7) on
    cells of 32^2), the gates set to GATE; both steps jitted, once a
    process.  Callers must not modify the trees."""
    jcfg = dataclasses.replace(jget_arch(name).reduced(), **kw)
    jmod = jmodel_module(jcfg)
    jparams = with_gate(jax.jit(lambda k: jPM.materialize(
        jmod.init_specs(jcfg), k))(jax.random.PRNGKey(0)), jcfg)
    jr, _ = rram_cfgs()
    jprog = jax.jit(lambda prm: jrram.program_rram(
        prm, jr, jax.random.PRNGKey(7))[0])(jparams)
    return jcfg, jmod, jparams, jprog


def rram_cfgs(**kw):
    kw = {"enabled": True, "cell_rows": 32, "cell_cols": 32, **kw}
    return JRRAM(**kw), RRAMBackendConfig(**kw)


def with_gate(jparams, cfg):
    """llama-vision's cross gates set to GATE (tanh(0) = 0 at init)."""
    if cfg.family != "llama_vision":
        return jparams
    attn = jparams["super"]["cross"]["attn"]
    attn["gate"] = jnp.full_like(attn["gate"], GATE)
    return jparams


def make_batch(cfg, b, t, seed):
    """Numpy tokens / labels, and frames or patches for the families that
    take them."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    batch = {"tokens": tokens,
             "labels": rng.integers(-1, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "whisper":
        batch["frames"] = rng.standard_normal(
            (b, FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.family == "llama_vision":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def hidden(mod, params, batch, cfg, rt):
    """Each family's forward pass to the final-norm hidden states."""
    if cfg.family in ("moe", "rwkv6", "zamba2"):
        return mod.forward(params, batch["tokens"], cfg, rt)[0]
    if cfg.family == "whisper":
        enc = mod.encode(params, batch["frames"], cfg, rt)
        return mod.decode(params, batch["tokens"], enc, cfg, rt)[0]
    return mod.forward(params, batch["tokens"], batch["patches"], cfg, rt)[0]


def runtimes(mode, steps=None):
    if mode == "digital":
        return jc.Runtime(), pc.Runtime()
    jr, pr = rram_cfgs(encode_inputs=mode == "dac_on")
    draws = DacDraws(JKEY, PKEY, steps=steps, salts=24)
    return (jc.Runtime(rram=jr, key=JKEY),
            pc.Runtime(rram=pr, key=PKEY, draw=draws))


def expected_salts(cfg, self_analog=False):
    """The salt of every analog dense call of one pass (forward, then the
    head) as the reference's scans hand them out: a scan's body takes its
    salts once and every layer it scans reuses them.  llama-vision's self
    layers are 4-D stacks that ``program_rram`` leaves digital; with
    ``self_analog`` they carry images (set by hand) and take the inner
    body's salts before the cross layer's."""
    d = 7 if cfg.act == "silu_gated" else 6          # attention 4 + mlp
    if cfg.family == "moe":
        body = list(range(1, 5))                     # the experts are digital
        seq, last = body * cfg.n_layers, 4
    elif cfg.family == "whisper":
        enc = list(range(1, d + 1))
        dec = list(range(d + 1, d + 1 + 4 + 4 + (d - 4)))
        seq, last = enc * cfg.n_enc_layers + dec * cfg.n_layers, dec[-1]
    else:
        n_super = cfg.n_layers // cfg.cross_attn_every
        per = cfg.cross_attn_every - 1
        self_ = list(range(1, d + 1)) if self_analog else []
        cross = list(range(len(self_) + 1, len(self_) + d + 1))
        seq, last = (self_ * per + cross) * n_super, cross[-1]
    return seq + [last + 1], last + 1


def recurrent_salts(cfg):
    """The salt of every analog dense call of one pass (forward, then the
    head): rwkv6's layer scan hands its nine salts to every layer; zamba2's
    Python group loop gives each shared-block invocation six fresh ones
    (its grouped mamba blocks are digital), and its tail scan one set of
    six for every tail block.  Returns (sequence, salts spent)."""
    if cfg.family == "rwkv6":
        return list(range(1, 10)) * cfg.n_layers + [10], 10
    groups = cfg.n_layers // cfg.attn_every
    tail = cfg.n_layers % cfg.attn_every
    seq = list(range(1, 6 * groups + 1))
    last = 6 * groups
    if tail:
        seq += list(range(last + 1, last + 7)) * tail
        last += 6
    return seq + [last + 1], last + 1


def with_self_images(jprog):
    """llama-vision's 4-D self-layer kernels given images by hand
    (``w_tilde`` 1 % off ``w``), so that the self layers' dense calls
    draw and the nested scans' key sharing shows."""
    def visit(tree):
        if "w" in tree and not isinstance(tree["w"], dict):
            w = tree["w"]
            return dict(tree, w_tilde=w * 1.01, dw=w - w * 1.01)
        return {k: visit(v) if isinstance(v, dict) else v
                for k, v in tree.items()}
    return dict(jprog, super=dict(jprog["super"],
                                  self=visit(jprog["super"]["self"])))
