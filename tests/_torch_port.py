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
