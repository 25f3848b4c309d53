"""Shared helpers of the ``test_torch_*`` files (the PyTorch port held to the
JAX package).

Inputs are made with numpy from fixed seeds and handed to both packages;
noise the port would draw from its own generators is drawn here with
``jax.random`` in the reference's key schedule and injected as ``eta``.
Nothing here changes process state beyond torch's thread count, which the
``few_threads`` fixture sets for a module and restores.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import crossbar as jcb


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Keep torch's CPU pool small: these files share workers with the JAX
    suite, whose subprocess tests have time limits."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def rng_array(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def program_eta(key, cfg, mb, nb):
    """The reference's programming draws, (mb, nb, cap_m, cap_n): block key
    -> split -> the k_a half -> normal over the per-tile view."""
    geom = cfg.geom
    cap_m, cap_n = geom.capacity
    tiles = (cap_m // geom.cell_rows, geom.cell_rows,
             cap_n // geom.cell_cols, geom.cell_cols)
    keys = jcb.block_keys(key, mb, nb)
    return np.stack([np.stack([
        np.asarray(jax.random.normal(jax.random.split(keys[i, j])[0], tiles,
                                     dtype=np.float32)).reshape(cap_m, cap_n)
        for j in range(nb)]) for i in range(mb)])


def block_dac_eta(key, cfg, mb, nb, batch, transpose=False):
    """The reference backend's per-block DAC draws, (mb, nb, cap, batch) with
    cap = cap_n forward and cap_m transposed: block key -> split -> the k_x
    half (the same half in both directions)."""
    cap = cfg.geom.capacity[0 if transpose else 1]
    keys = jcb.block_keys(key, mb, nb)
    return np.stack([np.stack([
        np.asarray(jax.random.normal(jax.random.split(keys[i, j])[1],
                                     (cap, batch), dtype=np.float32))
        for j in range(nb)]) for i in range(mb)])


def whole_dac_eta(key, np_, batch, transpose=False):
    """The kernel backend's single whole-vector DAC draw over the padded
    input: fold 1 of the key forward, fold 2 transposed."""
    fold = 2 if transpose else 1
    return np.array(jax.random.normal(jax.random.fold_in(key, fold),
                                      (np_, batch), dtype=np.float32))


# Per-member draws of a group: member g of a JAX group executes (and is
# programmed) under fold_in(key, g).

def member_keys(key, size):
    return [jax.random.fold_in(key, g) for g in range(size)]


def group_program_eta(key, cfg, mb, nb, size):
    """(size, mb, nb, cap_m, cap_n): each member's programming draws."""
    return np.stack([program_eta(k, cfg, mb, nb)
                     for k in member_keys(key, size)])


def group_block_dac_eta(key, cfg, mb, nb, batch, size, transpose=False):
    """(size, mb, nb, cap, batch): each member's per-block DAC draws."""
    return np.stack([block_dac_eta(k, cfg, mb, nb, batch, transpose)
                     for k in member_keys(key, size)])


def group_whole_dac_eta(key, np_, batch, size, transpose=False):
    """(size, Np, batch): each member's whole-vector DAC draw."""
    return np.stack([whole_dac_eta(k, np_, batch, transpose)
                     for k in member_keys(key, size)])


# Model programming and serving: the reference's draws in its key schedule.

def rram_program_etas(params, cfg, key):
    """One entry per programmed kernel of ``repro.models.rram.program_rram``'s
    walk over ``params`` (dict insertion order): kernel ``c`` keyed
    ``fold_in(key, c)``; a stacked (L, m, n) kernel's layers keyed
    ``split(fold_in(key, c), L)``.  ``cfg`` is the reference's
    ``crossbar_cfg``; the port's ``program_rram(eta=...)`` takes the list."""
    cap_m, cap_n = cfg.geom.capacity
    out = []

    def visit(tree):
        for name, sub in tree.items():
            if name == "w" and getattr(sub, "ndim", 0) in (2, 3):
                k = jax.random.fold_in(key, len(out) + 1)
                m, n = sub.shape[-2:]
                mb, nb = -(-m // cap_m), -(-n // cap_n)
                if sub.ndim == 2:
                    out.append(program_eta(k, cfg, mb, nb))
                else:
                    out.append(np.stack([
                        program_eta(kl, cfg, mb, nb)
                        for kl in jax.random.split(k, sub.shape[0])]))
            elif isinstance(sub, dict):
                visit(sub)

    visit(params)
    return out


class DacDraws:
    """The ``Runtime.draw`` hook that hands the port the reference's DAC
    draws.  The port keys a dense call ``fold_in(fold_in(base, step),
    salt)`` (or ``fold_in(base, salt)`` with ``steps=None``) with its own
    integer ``fold_in``; the reference ``jax.random.fold_in`` of its base
    key the same way.  ``calls`` records the (step, salt) of every draw;
    an unknown key raises.  ``dtype`` is the reference's activation dtype:
    it draws its normals in that dtype (bfloat16 normals are not float32
    normals rounded), handed over as float32 (exact)."""

    def __init__(self, jax_base, port_base, steps=None, salts=16,
                 dtype=np.float32):
        self.dtype = dtype
        from repro_torch.core.prng import fold_in
        self.keys = {}
        self.calls = []
        for step in (steps if steps is not None else [None]):
            jb = jax_base if step is None else jax.random.fold_in(jax_base,
                                                                  step)
            pb = port_base if step is None else fold_in(port_base, step)
            for salt in range(1, salts + 1):
                self.keys[fold_in(pb, salt)] = (
                    (step, salt), jax.random.fold_in(jb, salt))

    def __call__(self, key, shape):
        where, jkey = self.keys[key]
        self.calls.append(where)
        return torch.from_numpy(np.asarray(
            jax.random.normal(jkey, shape, dtype=self.dtype), np.float32))
