"""The paper's quantitative claims on the port: the five assertions of
tests/test_paper_claims.py, through the port's ``corrected_mvm`` and
``write_cost``, at the same bounds and replication counts.

These run on the port's own noise draws, so they check the claims, not the
draws.  Repetition r on device d is keyed ``fold_in(fold_in(0, r),
DEVICES.index(d))`` -- fixed integers, the same in every process (a
``hash(str)`` key would change with Python's per-process string salt).
"""
import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401
from repro_torch.core import (CrossbarConfig, MCAGeometry, corrected_mvm,
                              get_device, rel_l2, write_cost)
from repro_torch.core.matrices import paper_matrix
from repro_torch.core.prng import fold_in

GEOM = MCAGeometry(1, 1, 66, 66)
DEVICES = ["epiram", "ag-si", "alox-hfo2", "taox-hfox"]


def run_device(a, x, b, dev, ec, k=5, reps=6):
    """Mean rel-L2 of ``reps`` one-shot corrected MVMs, and the write cost."""
    cfg = CrossbarConfig(device=get_device(dev), geom=GEOM, k_iters=k, ec=ec)
    errs, stats = [], None
    for r in range(reps):
        y, stats = corrected_mvm(a, x, fold_in(fold_in(0, r),
                                               DEVICES.index(dev)), cfg)
        errs.append(float(rel_l2(y, b)))
    return float(np.mean(errs)), stats


@pytest.fixture(scope="module")
def m1():
    a = torch.from_numpy(paper_matrix("bcsstk02").astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(42).standard_normal(66)
                         .astype(np.float32))
    return a, x, a @ x


def test_ec_error_reduction_over_80pct(m1):
    """Paper: >90 % reduction of the first- and second-order error (gated at
    80 % at this replication, as the reference's test does)."""
    a, x, b = m1
    raw, _ = run_device(a, x, b, "taox-hfox", ec=False)
    ec, _ = run_device(a, x, b, "taox-hfox", ec=True)
    assert ec < 0.2 * raw, (raw, ec)


def test_low_end_device_matches_epiram(m1):
    """Paper: TaOx-HfOx + EC reaches EpiRAM-class accuracy at >= ~3 orders of
    magnitude less write energy and ~2 orders less latency."""
    a, x, b = m1
    epi, epi_stats = run_device(a, x, b, "epiram", ec=False)
    tao, tao_stats = run_device(a, x, b, "taox-hfox", ec=True)
    assert tao < 1.5 * epi, (tao, epi)
    assert epi_stats.energy_j / tao_stats.energy_j > 300
    assert epi_stats.latency_s / tao_stats.latency_s > 50


def test_write_verify_iterations_reduce_error(m1):
    a, x, b = m1
    e0, _ = run_device(a, x, b, "alox-hfo2", ec=False, k=0)
    e5, _ = run_device(a, x, b, "alox-hfo2", ec=False, k=5)
    assert e5 < e0


def test_error_flat_across_cell_sizes():
    """Paper Fig. 4: accuracy is preserved under virtualization."""
    n = 512
    rng = np.random.default_rng(0)
    a = torch.from_numpy((rng.standard_normal((n, n)) / np.sqrt(n))
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    b = a @ x
    errs = []
    for cell in (32, 128, 256):
        cfg = CrossbarConfig(device=get_device("taox-hfox"),
                             geom=MCAGeometry(2, 2, cell, cell), k_iters=5,
                             ec=True)
        y, _ = corrected_mvm(a, x, 0, cfg)
        errs.append(float(rel_l2(y, b)))
    assert max(errs) < 3 * min(errs) + 1e-3, errs


def test_small_cells_cost_more_energy_latency():
    """Paper Fig. 4: virtualization reassignments inflate E_w / L_w for
    small arrays."""
    dev = get_device("taox-hfox")
    small = CrossbarConfig(device=dev, geom=MCAGeometry(8, 8, 32, 32),
                           k_iters=5, ec=True)
    big = CrossbarConfig(device=dev, geom=MCAGeometry(8, 8, 512, 512),
                         k_iters=5, ec=True)
    assert write_cost(4096, 4096, small).latency_s > \
        5 * write_cost(4096, 4096, big).latency_s
