"""The port's reliability package held to :mod:`repro.reliability`: fault
probability without underflow, the age ledger, ``aged_blocks`` with the
reference's fault draws injected (identical latch masks) and on the port's
own draws (replay, monotone in age, a refresh redraws), the aged execute
(both directions, solo and grouped) and the ledger after a host call, a
probe and a solve, the probes and the tile refresh, ``ft_cg`` / ``ft_pdhg``
(healthy, a fault recovered, a fault left unrepaired) with the DAC off,
``cg`` / ``pdhg(divergence=)``, checkpoints across the two packages, and
the refusals of aged execution outside the reference backend's local
placement."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (block_dac_eta, few_threads,  # noqa: F401
                         group_block_dac_eta, rel, rng_array, to_np)
from repro import solvers as jsol
from repro.core import crossbar as jcb
from repro.core import devices as jdev
from repro.core import virtualization as jvirt
from repro.distributed.fault_tolerance import CheckpointManager as JaxManager
from repro.engine import AnalogEngine as JaxEngine
from repro import reliability as jrel
from repro.reliability import aging as jaging
from repro_torch import reliability as trel
from repro_torch import solvers
from repro_torch.core.prng import block_key, fold_in
from repro_torch.distributed import CheckpointManager, Watchdog
from repro_torch.engine import AnalogEngine
from repro_torch.interop import (config_from_dict, group_from_numpy,
                                 image_from_numpy)
from repro_torch.launch import make_mesh
from repro_torch.reliability.aging import (FAULT_SALT, AgeLedger,
                                           attach_group_age)
from repro_torch.reliability.refresh import REFRESH_SALT

TOL = 1e-5
KEY = jax.random.PRNGKey(0)
N = 128


def configs(device="epiram", cell=32, **kw):
    """tests/test_reliability.py's handle geometry, both packages."""
    cfg = jcb.CrossbarConfig(device=jdev.get_device(device),
                             geom=jvirt.MCAGeometry(2, 2, cell, cell),
                             k_iters=5, ec=True, **kw)
    return cfg, config_from_dict(dataclasses.asdict(cfg))


def spd(n=N, seed=0):
    """``R + R^T + 2I`` with R ~ N(0, 1) / n, a solution and its RHS."""
    r = rng_array((n, n), seed) / n
    a = r + r.T + 2.0 * np.eye(n, dtype=np.float32)
    x_true = rng_array((n,), seed + 1)
    return a, x_true, (a @ x_true).astype(np.float32)


def jax_handle(a, cfg, backend="reference"):
    return JaxEngine(cfg, backend=backend).program(jnp.asarray(a),
                                                   jax.random.fold_in(KEY, 7))


def port_handle(ja, pcfg, backend="reference"):
    """The JAX handle's image as a port handle (base key 0)."""
    return image_from_numpy(np.asarray(ja.at_blocks), np.asarray(ja.da_blocks),
                            ja.shape, pcfg, "cpu", backend=backend)


def ref_fault_draws(age):
    """The reference's fault uniforms of a (mb, nb) ledger: block (i, j)
    draws uniform(fold_in(fault_keys[i, j], refresh_count[i, j]), (2,
    cap_m, cap_n)); returns (mb, nb, 2, cap_m, cap_n) for the capacity the
    caller's blocks have (passed as ``shape``)."""
    def draws(shape):
        mb, nb = age.mvms.shape
        return np.stack([np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(age.fault_keys[i, j],
                               age.refresh_count[i, j]),
            (2,) + shape, jnp.float32)) for j in range(nb)])
            for i in range(mb)])
    return draws


def ref_pass_draws(key, shape, max_iters):
    """The reference verify loop's per-pass draws (pass k: normal of
    split(key_k)[1]; key_{k+1} = split(key_k)[0])."""
    out = []
    for _ in range(max_iters + 1):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def port_ledger(jled, draws=None):
    """A port ledger with the reference ledger's counts (port keys)."""
    mb, nb = jled.mvms.shape
    led = AgeLedger.fresh(0, mb, nb)
    return dataclasses.replace(
        led, mvms=torch.from_numpy(np.array(jled.mvms)),
        seconds=torch.from_numpy(np.array(jled.seconds)),
        refresh_count=torch.from_numpy(np.array(jled.refresh_count)),
        draws=None if draws is None else torch.from_numpy(draws))


# ----------------------------------------------------------------- aging
@pytest.mark.parametrize("mvms", [0.0, 1.0, 1e5, 2e5, 6e7])
@pytest.mark.parametrize("device", ["epiram", "ag-si"])
def test_fault_probability_matches_without_underflow(device, mvms):
    """``-expm1(N log1p(-rate))`` in float32, as the reference computes it;
    at 1e-9 the naive form is 0 and this one is not."""
    got = float(trel.fault_probability(
        config_from_dict(dataclasses.asdict(configs(device)[0])).device,
        mvms))
    want = float(jrel.fault_probability(jdev.get_device(device), mvms))
    assert got == pytest.approx(want, rel=1e-6, abs=0.0)
    if device == "epiram" and mvms == 1e5:
        assert got == pytest.approx(1e-4, rel=0.01)
        naive = 1.0 - (np.float32(1.0) - np.float32(1e-9)) ** np.float32(mvms)
        assert naive == 0.0 < got


def test_predicted_residual_matches():
    for name in ("epiram", "taox-hfox", "ag-si"):
        pdev = config_from_dict(dataclasses.asdict(configs(name)[0])).device
        for kw in (dict(seconds=0.0, mvms=0.0), dict(seconds=100.0, mvms=1e4),
                   dict(seconds=3600.0, mvms=5e6)):
            assert trel.predicted_residual(pdev, k_iters=5, n=256, **kw) == \
                pytest.approx(jrel.predicted_residual(
                    jdev.get_device(name), k_iters=5, n=256, **kw), rel=1e-12)


def test_age_ledger_functional_updates_match_reference():
    """fresh / advanced / elapsed / reset: the same counts as the
    reference's ledger, the original untouched, and the fault keys the
    port's block keys of fold_in(base, FAULT_SALT)."""
    jled = jaging.AgeLedger.fresh(KEY, 2, 3)
    led = AgeLedger.fresh(11, 2, 3)
    assert led.grid == (2, 3) and led.fault_keys.dtype == torch.int64
    assert int(led.fault_keys[1, 2]) == block_key(fold_in(11, FAULT_SALT),
                                                  1, 2)
    mask = np.array([[True, False, False], [False, False, True]])
    jl = jled.advanced(10).elapsed(5.0).reset(jnp.asarray(mask)).advanced(3)
    pl = led.advanced(10).elapsed(5.0).reset(mask).advanced(3)
    assert float(led.mvms.max()) == 0.0 and float(led.seconds.max()) == 0.0
    for f in ("mvms", "seconds", "refresh_count"):
        np.testing.assert_array_equal(to_np(getattr(pl, f)),
                                      np.asarray(getattr(jl, f)))
    assert pl.refresh_count.dtype == torch.int32
    assert torch.equal(pl.fault_keys, led.fault_keys)


@pytest.mark.parametrize("case", ["faults", "faults+drift", "refreshed"])
def test_aged_blocks_match_reference_with_its_draws(case):
    """With the reference's uniforms injected: the same latch mask (exact)
    and values within 1e-6, drift and refreshed blocks included."""
    a, _, _ = spd()
    cfg, pcfg = configs("ag-si")
    ja = jax_handle(a, cfg)
    jled = jrel.attach_age(ja)
    n1 = int(40.0 / (cfg.device.fault_rate * a.size))   # ~40 faults
    jled = jled.advanced(n1)
    if case == "faults+drift":
        jled = jled.elapsed(3600.0)
    if case == "refreshed":
        jled = jled.reset(jnp.asarray([[True, False], [False, True]])) \
            .advanced(2 * n1)
    want = np.asarray(jaging.aged_blocks(ja.at_blocks, jled, cfg.device))
    A = port_handle(ja, pcfg)
    draws = ref_fault_draws(jled)(pcfg.geom.capacity)
    got = to_np(trel.aged_blocks(A.at_blocks, port_ledger(jled), pcfg.device,
                                 u=torch.from_numpy(draws)))
    at = np.asarray(ja.at_blocks)
    decay = float(jdev.drift_factor(cfg.device, jled.seconds[0, 0]))
    want_mask = np.abs(want - at * decay) > 0
    got_mask = np.abs(got - at * decay) > 0
    assert want_mask.sum() >= 20
    np.testing.assert_array_equal(got_mask, want_mask)
    assert float(np.abs(got - want).max()) <= 1e-6
    # The same through age.draws, the engine's route.
    again = trel.aged_blocks(A.at_blocks, port_ledger(jled, draws),
                             pcfg.device)
    assert np.array_equal(to_np(again), got)


def test_age_zero_is_identity():
    a, _, _ = spd()
    _, pcfg = configs()
    A = AnalogEngine(pcfg, device="cpu").program(a, 3)
    led = trel.attach_age(A)
    assert torch.equal(trel.aged_blocks(A.at_blocks, led, pcfg.device),
                       A.at_blocks)
    # A device without faults drifts only.
    nofault = dataclasses.replace(pcfg.device, fault_rate=0.0)
    aged = trel.aged_blocks(A.at_blocks, led.advanced(10 ** 9).elapsed(60.0),
                            nofault)
    assert torch.allclose(aged, A.at_blocks * float(
        (1.0 + 60.0 / nofault.drift_t0) ** -nofault.drift_nu), rtol=1e-6)


def test_aged_blocks_replay_monotone_and_refresh_redraws():
    """The port's own draws at >= 20 expected faults: the same age gives
    the same faulted set, the set only grows with age, a refresh redraws."""
    a, _, _ = spd()
    _, pcfg = configs("ag-si")
    A = AnalogEngine(pcfg, device="cpu").program(a, 7)
    led = trel.attach_age(A)
    dev = pcfg.device
    n1 = int(20.0 / (dev.fault_rate * a.size))

    def stuck(ledger):
        return to_np((trel.aged_blocks(A.at_blocks, ledger, dev)
                      - A.at_blocks).abs() > 1e-9)

    s1, s1b = stuck(led.advanced(n1)), stuck(led.advanced(n1))
    np.testing.assert_array_equal(s1, s1b)
    s2 = stuck(led.advanced(5 * n1))
    assert s1.sum() >= 10
    assert np.all(s2[s1]) and s2.sum() > s1.sum()
    s3 = stuck(led.advanced(n1).reset(np.ones((2, 2), bool)).advanced(n1))
    assert not np.array_equal(s3, s1)


# ---------------------------------------------------- the aged execute
def aged_pair(device="ag-si", faults=30.0, seconds=600.0, **kw):
    """A JAX handle and its port twin, both aged alike (the port with the
    reference's fault draws injected)."""
    a, x, b = spd()
    cfg, pcfg = configs(device, **kw)
    ja = jax_handle(a, cfg)
    jrel.attach_age(ja)
    n1 = int(faults / (cfg.device.fault_rate * a.size))
    ja.age = ja.age.advanced(n1).elapsed(seconds)
    A = port_handle(ja, pcfg)
    trel.attach_age(A, draws=torch.from_numpy(
        ref_fault_draws(ja.age)(pcfg.geom.capacity)))
    A.age = A.age.advanced(n1).elapsed(seconds)
    return a, x, b, cfg, pcfg, ja, A


@pytest.fixture
def reference_trace_check(monkeypatch):
    """The reference engine asks ``jax.core.trace_state_clean`` whether it
    runs under a trace, so that a jitted solve does not advance the ledger;
    jax 0.9.0 has it in ``jax._src.core`` only, and the reference's
    fallback (``lambda: True``) would write a tracer into the ledger.  The
    reference runs here with the function it was written against."""
    import jax._src.core as jcore
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jcore.trace_state_clean, raising=False)


def assert_same_ledger(pl, jl):
    for f in ("mvms", "seconds", "refresh_count"):
        np.testing.assert_array_equal(to_np(getattr(pl, f)),
                                      np.asarray(getattr(jl, f)))


@pytest.mark.parametrize("transpose", [False, True])
def test_aged_mvm_matches_reference_engine(transpose):
    """An aged ``A @ x`` / ``A.T @ y`` on the reference backend against the
    JAX engine's aged execute (its DAC and fault draws injected), and one
    read disturb on the ledger for the host call in both."""
    a, x, _, cfg, pcfg, ja, A = aged_pair()
    u = rng_array((N, 3), 41)
    want = (ja.T if transpose else ja) @ jnp.asarray(u)     # call 0
    eta = block_dac_eta(jax.random.fold_in(KEY, 7), cfg, 2, 2, 3,
                        transpose=transpose)
    run = A.engine.rmvm if transpose else A.engine.mvm
    got = run(A, torch.from_numpy(u), eta=torch.from_numpy(eta))
    assert rel(got, want) <= TOL
    assert_same_ledger(A.age, ja.age)
    # The aged answer is not the fresh one.
    fresh = port_handle(ja, pcfg)
    assert rel(got, (fresh.engine.rmvm if transpose else fresh.engine.mvm)(
        fresh, torch.from_numpy(u), eta=torch.from_numpy(eta))) > 1e-3


def test_aged_group_matches_reference_engine():
    """``group_mvm`` / ``group_rmvm`` of an aged group against the JAX
    grouped aged execute; every member's ledger advances by one a call."""
    size = 3
    cfg, pcfg = configs("ag-si")
    stack = np.stack([spd(N, 10 * g)[0] for g in range(size)])
    jeng = JaxEngine(cfg)
    key = jax.random.PRNGKey(5)
    jg = jeng.program_group(jnp.asarray(stack), key)
    jages = jaging.attach_group_age(jg)
    n1 = int(30.0 / (cfg.device.fault_rate * N * N))
    jg.ages = jages.advanced(n1).elapsed(60.0)
    cap = pcfg.geom.capacity
    draws = np.stack([ref_fault_draws(jax.tree_util.tree_map(
        lambda t, g=g: t[g], jg.ages))(cap) for g in range(size)])
    G = group_from_numpy(np.asarray(jg.at_blocks), np.asarray(jg.da_blocks),
                         jg.shape, pcfg, "cpu")
    attach_group_age(G, draws=torch.from_numpy(draws))
    G.ages = G.ages.advanced(n1).elapsed(60.0)
    x = rng_array((N, 2), 42)
    y = rng_array((N, 2), 43)
    want_f = jeng.group_mvm(jg, jnp.asarray(x))
    want_b = jeng.group_rmvm(jg, jnp.asarray(y))
    keys = [jax.random.fold_in(k, 1) for k in
            [jax.random.fold_in(key, g) for g in range(size)]]
    eta_f = group_block_dac_eta(key, cfg, 2, 2, 2, size)
    eta_b = np.stack([block_dac_eta(k, cfg, 2, 2, 2, transpose=True)
                      for k in keys])
    got_f = G.engine.group_mvm(G, torch.from_numpy(x),
                               eta=torch.from_numpy(eta_f))
    got_b = G.engine.group_rmvm(G, torch.from_numpy(y),
                                eta=torch.from_numpy(eta_b))
    assert rel(got_f, want_f) <= TOL and rel(got_b, want_b) <= TOL
    for g in range(size):
        assert_same_ledger(G.ages.member(g), jax.tree_util.tree_map(
            lambda t, g=g: t[g], jg.ages))
    assert float(G.ages.mvms.min()) == n1 + 2


def test_aged_group_member_equals_solo_aged_handle():
    """Member g of an aged group executes what a solo handle aged from its
    own key executes, bit for bit (the port's own draws)."""
    _, pcfg = configs("ag-si")
    stack = torch.from_numpy(np.stack([spd(N, 10 * g)[0] for g in range(3)]))
    eng = AnalogEngine(pcfg, device="cpu")
    G = eng.program_group(stack, 9)
    n1 = int(30.0 / (pcfg.device.fault_rate * N * N))
    G.ages = attach_group_age(G).advanced(n1).elapsed(60.0)
    x = torch.from_numpy(rng_array((N, 2), 44))
    out = eng.group_mvm(G, x)
    for g in (0, 2):
        solo = G.member(g)
        solo.age = trel.attach_age(solo).advanced(n1).elapsed(60.0)
        assert torch.equal(out[g], eng.mvm(solo, x))


def test_ledger_after_host_call_probe_and_solve_matches_reference(
        reference_trace_check):
    """A solve holds the age (its MVMs are the operator's), a host call
    adds one, a probe nb; the same ledgers as the reference's."""
    _, x, b, cfg, pcfg, ja, A = aged_pair(faults=5.0, seconds=0.0)
    jsol.cg(ja, jnp.asarray(b), tol=1e-6, maxiter=20,
            key=jax.random.fold_in(KEY, 11))
    res = solvers.cg(A, b, tol=1e-6, maxiter=20, key=3)
    assert res.iterations > 0
    assert_same_ledger(A.age, ja.age)
    ja @ jnp.asarray(x)
    A @ torch.from_numpy(x)
    jrel.probe_tile_scores(ja, key=jax.random.fold_in(KEY, 12))
    trel.probe_tile_scores(A, key=5)
    assert_same_ledger(A.age, ja.age)
    solvers.pdhg(A, b, np.ones(N, np.float32), maxiter=3, key=1)
    assert_same_ledger(A.age, ja.age)


# -------------------------------------------------------- probes + refresh
@pytest.mark.parametrize("shape", [(100, 4, 32), (256, 2, 128), (64, 1, 64)])
def test_probe_vectors_match(shape):
    got = trel.probe_vectors(*shape, device="cpu")
    want = np.asarray(jrel.probe_vectors(*shape))
    assert float(np.abs(to_np(got) - want).max()) <= 1e-6
    np.testing.assert_array_equal(to_np(got) == 0.0, want == 0.0)


@pytest.mark.parametrize("aged", [False, True])
def test_probe_scores_match_reference(aged):
    """One batched probe call against the reference's, its DAC (and fault)
    draws injected: scores within 1e-5, the input cost and nb probes."""
    if aged:
        _, _, _, cfg, pcfg, ja, A = aged_pair(faults=6.0, seconds=0.0)
    else:
        a, _, _ = spd()
        cfg, pcfg = configs()
        ja = jax_handle(a, cfg)
        A = port_handle(ja, pcfg)
    pkey = jax.random.fold_in(KEY, 3)
    want = jrel.probe_tile_scores(ja, key=pkey)
    got = trel.probe_tile_scores(A, eta=torch.from_numpy(
        block_dac_eta(pkey, cfg, 2, 2, 2)))
    assert got.scores.shape == (2, 2) and got.n_probes == want.n_probes == 2
    # A score is a relative error, so a fresh tile's (~1e-4) carries the
    # fp32 rounding of its MVM: held absolutely, and relatively when aged.
    assert float(np.abs(to_np(got.scores)
                        - np.asarray(want.scores)).max()) <= 1e-6
    if aged:
        assert rel(got.scores, want.scores) <= TOL
    assert got.input_stats.energy_j == pytest.approx(
        float(want.input_stats.energy_j), rel=1e-6)
    assert abs(got.worst - want.worst) <= 1e-6
    if aged:
        assert_same_ledger(A.age, ja.age)


def test_select_tiles_matches():
    scores = np.array([[0.5, 0.01, 0.3], [0.2, 0.9, 0.05]])
    for pol in ((0.1, None), (0.1, 1), (0.04, 2), (2.0, None), (0.0, None)):
        want = jrel.select_tiles(scores, jrel.RefreshPolicy(*pol))
        assert trel.select_tiles(torch.from_numpy(scores),
                                 trel.RefreshPolicy(*pol)) == want
        assert trel.select_tiles(scores, trel.RefreshPolicy(*pol)) == want


def test_refresh_tiles_matches_reference():
    """The same tiles from the same scores, each tile's new image within
    1e-6 under the reference's verify draws, the same WriteStats, the
    ledger reset on those tiles, and a cheaper bill than a full rewrite."""
    _, _, _, cfg, pcfg, ja, A = aged_pair(faults=6.0, seconds=0.0)
    pkey = jax.random.fold_in(KEY, 3)
    rep = jrel.probe_tile_scores(ja, key=pkey)
    trel.probe_tile_scores(A, eta=torch.from_numpy(
        block_dac_eta(pkey, cfg, 2, 2, 2)))
    policy = jrel.RefreshPolicy(threshold=float(np.sort(
        np.asarray(rep.scores).ravel())[1]) * 0.999)
    rkey = jax.random.fold_in(KEY, 4)
    src = np.asarray(ja.at_blocks) + np.asarray(ja.da_blocks)
    tiles = jrel.select_tiles(rep.scores, policy)
    assert 0 < len(tiles) < 4
    stream = jax.random.fold_in(rkey, jrel.refresh.REFRESH_SALT)
    eta = [torch.from_numpy(ref_pass_draws(jax.random.fold_in(
        jax.random.fold_in(stream, i * 2 + j), 0), src.shape[2:], 5))
        for i, j in tiles]
    want = jrel.refresh_tiles(ja, rep.scores, policy, key=rkey)
    got = trel.refresh_tiles(A, rep.scores, trel.RefreshPolicy(
        policy.threshold), eta=eta)
    assert got.tiles == want.tiles == tiles
    for i, j in tiles:
        assert float(np.abs(to_np(A.at_blocks[i, j])
                            - np.asarray(ja.at_blocks[i, j])).max()) <= 1e-6
        assert float(np.abs(to_np(A.da_blocks[i, j])
                            - np.asarray(ja.da_blocks[i, j])).max()) <= 1e-6
    for f in ("energy_j", "latency_s", "final_delta"):
        assert getattr(got.write_stats, f) == pytest.approx(
            float(getattr(want.write_stats, f)), rel=1e-6)
    assert got.write_stats.iterations == int(want.write_stats.iterations)
    assert got.full_rewrite_stats.energy_j == pytest.approx(
        float(want.full_rewrite_stats.energy_j), rel=1e-6)
    assert got.energy_saving == pytest.approx(want.energy_saving, rel=1e-5)
    assert_same_ledger(A.age, ja.age)
    assert REFRESH_SALT == jrel.refresh.REFRESH_SALT


def test_refresh_own_keys_and_no_candidates():
    """Without injected draws the refresh keys are the port's stream (the
    same tiles twice give the same image); no candidate changes nothing."""
    a, _, _ = spd()
    _, pcfg = configs("ag-si")
    images = []
    for _ in range(2):
        A = AnalogEngine(pcfg, device="cpu").program(a, 7)
        scores = torch.tensor([[0.2, 0.0], [0.0, 0.3]])
        rr = trel.refresh_tiles(A, scores, trel.RefreshPolicy(0.1), key=9)
        assert rr.tiles == ((1, 1), (0, 0)) and A.age is None
        images.append(A.at_pad.clone())
    assert torch.equal(images[0], images[1])
    before = A.at_pad.clone()
    rr = trel.refresh_tiles(A, np.zeros((2, 2)), trel.RefreshPolicy(0.1))
    assert rr.tiles == () and rr.write_stats.energy_j == 0.0
    assert torch.equal(A.at_pad, before)


# -------------------------------------------------------------- ft solves
def dac_off_pair(cell=32, a=None):
    """A JAX handle and its port twin with the input DAC off (executes are
    then deterministic), programmed by the reference."""
    cfg, pcfg = configs(cell=cell, encode_inputs=False)
    if a is None:
        a = spd()[0]
    ja = jax_handle(a, cfg)
    return cfg, pcfg, ja, port_handle(ja, pcfg)


def same_run(got, want):
    assert got.iterations == want.iterations
    assert got.restores == want.restores
    assert got.converged == want.converged
    assert [(e.kind, e.segment, e.restored_step) for e in got.fault_events] \
        == [(e.kind, e.segment, e.restored_step) for e in want.fault_events]
    assert rel(got.x, want.x) <= TOL
    assert got.ledger.mvms == int(want.ledger.mvms)


def stuck_column(state, at_of, set_at):
    """A segment hook that latches column 3 of block column 0 at the rail
    at segment 1, and its repair."""
    def inject(seg, h):
        if seg == 1 and state.get("saved") is None:
            state["saved"] = at_of(h)
            set_at(h, "stuck")

    def repair(event, h):
        set_at(h, state["saved"])
    return inject, repair


@pytest.mark.parametrize("case", ["healthy", "recovered", "unrepaired"])
def test_ft_cg_matches_reference(tmp_path, case):
    cfg, pcfg, ja, A = dac_off_pair()
    b = spd()[2]
    jstate, pstate = {}, {}

    def jset(h, v):
        if isinstance(v, str):
            blocks = np.array(h.at_blocks)
            blocks[:, 0, :, 3] = np.max(np.abs(blocks))
            v = jnp.asarray(blocks)
        h.at_blocks = v
        h.release()

    def pset(h, v):
        if isinstance(v, str):
            v = h.at_pad.clone()
            v[:, 3] = h.at_pad.abs().max()
        h.at_pad = v

    kw = dict(tol=1e-4, maxiter=400, segment=25)
    jkw, pkw = {}, {}
    if case != "healthy":
        jin, jrep = stuck_column(jstate, lambda h: h.at_blocks, jset)
        pin, prep = stuck_column(pstate, lambda h: h.at_pad, pset)
        if case == "unrepaired":
            kw.update(tol=1e-6, max_restores=2)
            jin = lambda seg, h: jset(h, "stuck") if seg == 0 else None  # noqa
            pin = lambda seg, h: pset(h, "stuck") if seg == 0 else None  # noqa
            jkw, pkw = dict(segment_hook=jin), dict(segment_hook=pin)
        else:
            jkw = dict(segment_hook=jin, on_fault=jrep)
            pkw = dict(segment_hook=pin, on_fault=prep)
    want = jrel.ft_cg(ja, jnp.asarray(b), key=jax.random.fold_in(KEY, 9),
                      manager=JaxManager(str(tmp_path / "jax")), **kw, **jkw)
    mgr = CheckpointManager(str(tmp_path / "port"))
    got = trel.ft_cg(A, torch.from_numpy(b), key=9, manager=mgr, **kw,
                     **pkw)
    same_run(got, want)
    assert got.solver == "ft-cg"
    if case == "healthy":
        assert got.converged and got.restores == 0
        assert got.fault_events == () and mgr.latest_step() == got.iterations
    elif case == "recovered":
        assert got.converged and got.restores == 1
    else:
        assert not got.converged and got.restores == 3
    assert abs(got.final_residual - want.final_residual) <= 1e-6


@pytest.mark.parametrize("case", ["healthy", "recovered"])
def test_ft_pdhg_matches_reference(tmp_path, case):
    """tests/test_reliability.py's LP (48 x 64, MCAs of 16^2), DAC off;
    a NaN written into block (0, 0) before segment 0 and repaired."""
    a, b, c, _, _ = jsol.random_feasible_lp(jax.random.fold_in(KEY, 11),
                                            48, 64)
    cfg, pcfg, ja, A = dac_off_pair(cell=16, a=np.asarray(a))
    jstate, pstate = {}, {}

    def jin(seg, h):
        if jstate.get("saved") is None:
            jstate["saved"] = h.at_blocks
            blocks = np.array(h.at_blocks)
            blocks[0, 0, 0, 0] = np.nan
            h.at_blocks = jnp.asarray(blocks)
            h.release()

    def jrep(event, h):
        h.at_blocks = jstate["saved"]
        h.release()

    def pin(seg, h):
        if pstate.get("saved") is None:
            pstate["saved"] = h.at_pad
            h.at_pad = h.at_pad.clone()
            h.at_pad[0, 0] = float("nan")

    def prep(event, h):
        h.at_pad = pstate["saved"]

    # The power iteration starts from each package's own draw: 200 steps
    # take both step sizes to the operator's norm in fp32, 16 do not.
    kw = dict(tol=5e-2, maxiter=3000, segment=200, power_iters=200)
    jkw = dict(segment_hook=jin, on_fault=jrep) if case != "healthy" else {}
    pkw = dict(segment_hook=pin, on_fault=prep) if case != "healthy" else {}
    want = jrel.ft_pdhg(ja, b, c, key=jax.random.fold_in(KEY, 12),
                        manager=JaxManager(str(tmp_path / "jax")), **kw,
                        **jkw)
    got = trel.ft_pdhg(A, np.array(b), np.array(c), key=12,
                       manager=CheckpointManager(str(tmp_path / "port")),
                       **kw, **pkw)
    same_run(got, want)
    assert got.converged and got.restores == (0 if case == "healthy" else 1)
    assert rel(got.dual, want.dual) <= TOL and got.solver == "ft-pdhg"
    for f in ("mvms_t", "mvms_single", "mvms_single_t"):
        assert getattr(got.ledger, f) == int(getattr(want.ledger, f))


def test_ft_solves_bill_an_attached_ledger_once(tmp_path,
                                               reference_trace_check):
    """Each segment's MVMs land on the ledger once: the solve itself holds
    the age, the wrapper bills the segment (the reference's count)."""
    _, _, b, cfg, pcfg, ja, A = aged_pair(faults=1.0, seconds=0.0)
    start = float(A.age.mvms[0, 0])
    want = jrel.ft_cg(ja, jnp.asarray(b), tol=1e-4, segment=25,
                      key=jax.random.fold_in(KEY, 9),
                      manager=JaxManager(str(tmp_path / "jax")))
    got = trel.ft_cg(A, b, tol=1e-4, segment=25, key=9,
                     manager=CheckpointManager(str(tmp_path / "port")))
    assert float(A.age.mvms[0, 0]) == start + got.ledger.mvms
    assert float(ja.age.mvms[0, 0]) == start + int(want.ledger.mvms)
    assert got.converged and want.converged


# ---------------------------------------------------- divergence in solvers
def test_divergence_none_is_todays_numerics():
    """divergence=None is the plain loop bit for bit; a huge factor does
    not change a healthy solve (CG and PDHG)."""
    a, _, b = spd(64)
    r0 = solvers.cg(a, b, tol=1e-6, maxiter=40, device="cpu")
    r1 = solvers.cg(a, b, tol=1e-6, maxiter=40, divergence=None,
                    device="cpu")
    r2 = solvers.cg(a, b, tol=1e-6, maxiter=40, divergence=1e9,
                    device="cpu")
    assert torch.equal(r0.x, r1.x) and torch.equal(r0.x, r2.x)
    assert r0.iterations == r1.iterations == r2.iterations
    la, lb, lc, _, _ = solvers.random_feasible_lp(0, 16, 24, device="cpu")
    p0 = solvers.pdhg(la, lb, lc, maxiter=300, key=2)
    p1 = solvers.pdhg(la, lb, lc, maxiter=300, key=2, divergence=None)
    p2 = solvers.pdhg(la, lb, lc, maxiter=300, key=2, divergence=1e9)
    assert torch.equal(p0.x, p1.x) and torch.equal(p0.x, p2.x)
    assert p0.iterations == p1.iterations == p2.iterations


@pytest.mark.parametrize("factor", [1.5, 3.0])
def test_cg_divergence_exits_at_reference_iteration(factor):
    """CG on a symmetric indefinite matrix spikes; with ``divergence`` it
    exits at the reference's iteration with the reference's iterate."""
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    a = (q * np.linspace(-1.0, 3.0, 40)) @ q.T
    a = ((a + a.T) / 2).astype(np.float32)
    b = rng_array((40, 2), 6)
    want = jsol.cg(jnp.asarray(a), jnp.asarray(b), tol=1e-8, maxiter=200,
                   divergence=factor)
    got = solvers.cg(torch.from_numpy(a), torch.from_numpy(b), tol=1e-8,
                     maxiter=200, divergence=factor)
    plain = solvers.cg(torch.from_numpy(a), torch.from_numpy(b), tol=1e-8,
                       maxiter=200)
    assert 0 < got.iterations == int(want.iterations) < plain.iterations
    assert rel(got.x, want.x) <= TOL
    assert got.ledger.mvms == int(want.ledger.mvms)


def test_cg_divergence_exits_on_nan():
    """A NaN residual ends the loop at once (the reference's first exit)."""
    a, _, b = spd(32)
    a[3, 5] = np.nan
    want = jsol.cg(jnp.asarray(a), jnp.asarray(b), maxiter=50, divergence=10)
    got = solvers.cg(torch.from_numpy(a), torch.from_numpy(b), maxiter=50,
                     divergence=10)
    assert got.iterations == int(want.iterations) <= 1
    assert not got.converged


def test_pdhg_divergence_exits_at_reference_iteration():
    """PDHG with steps far beyond ``1 / ||A||`` diverges; with
    ``divergence`` it exits at the reference's iteration."""
    la, lb, lc, _, _ = jsol.random_feasible_lp(jax.random.PRNGKey(3), 12, 20)
    kw = dict(tol=1e-6, maxiter=500, tau=4.0, sigma=4.0, divergence=5.0)
    want = jsol.pdhg(la, lb, lc, **kw)
    got = solvers.pdhg(torch.from_numpy(np.array(la)),
                       torch.from_numpy(np.array(lb)),
                       torch.from_numpy(np.array(lc)), **kw)
    assert 0 < got.iterations == int(want.iterations) < 500
    assert rel(got.x, want.x) <= TOL and rel(got.dual, want.dual) <= TOL
    assert got.ledger.mvms == int(want.ledger.mvms)


# ------------------------------------------------------------- checkpoints
def tree_np(tree):
    return {k: (tree_np(v) if isinstance(v, dict) else
                [np.asarray(to_np(t)) for t in v] if isinstance(v, list)
                else np.asarray(to_np(v))) for k, v in tree.items()}


def test_checkpoint_written_by_jax_restores_in_port(tmp_path):
    jtree = {"x": jnp.asarray(rng_array((5, 2), 1)),
             "opt": {"mu": jnp.asarray(rng_array((3,), 2)),
                     "steps": [jnp.arange(4, dtype=jnp.int32),
                               jnp.float32(0.5)]}}
    JaxManager(str(tmp_path)).save(7, jtree, blocking=True,
                                   extra={"rel": 0.25})
    template = {"x": torch.zeros(5, 2, dtype=torch.float64),
                "opt": {"mu": torch.zeros(3),
                        "steps": [torch.zeros(4, dtype=torch.int64),
                                  torch.zeros(())]}}
    mgr = CheckpointManager(str(tmp_path))
    got = mgr.restore(template)
    assert got["x"].dtype == torch.float64
    assert got["opt"]["steps"][0].dtype == torch.int64
    want = tree_np(jtree)
    np.testing.assert_allclose(to_np(got["x"]), want["x"], rtol=0)
    np.testing.assert_array_equal(to_np(got["opt"]["mu"]), want["opt"]["mu"])
    np.testing.assert_array_equal(to_np(got["opt"]["steps"][0]),
                                  want["opt"]["steps"][0])
    assert float(got["opt"]["steps"][1]) == 0.5
    man = mgr.manifest()
    assert man["step"] == 7 and man["extra"] == {"rel": 0.25}


def test_checkpoint_written_by_port_restores_in_jax(tmp_path):
    import collections
    Pair = collections.namedtuple("Pair", "idx w")
    tree = {"y": torch.from_numpy(rng_array((4, 3), 3)),
            "pair": (torch.arange(3), torch.ones(2, dtype=torch.float64)),
            "nt": Pair(torch.tensor([7, 8]), None)}
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for step in range(4):
        mgr.save(step, tree, extra={"segment": step})   # background writer
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    template = {"y": jnp.zeros((4, 3)), "pair": (jnp.zeros(3, jnp.int32),
                                                 jnp.zeros(2)),
                "nt": Pair(jnp.zeros(2, jnp.int32), None)}
    got = JaxManager(str(tmp_path)).restore(template)
    np.testing.assert_array_equal(np.asarray(got["y"]), to_np(tree["y"]))
    np.testing.assert_array_equal(np.asarray(got["pair"][0]), [0, 1, 2])
    np.testing.assert_array_equal(np.asarray(got["nt"].idx), [7, 8])
    back = mgr.restore({"y": torch.zeros(4, 3), "pair": (
        torch.zeros(3, dtype=torch.int64), torch.zeros(2)),
        "nt": Pair(torch.zeros(2, dtype=torch.int64), None)})
    assert isinstance(back["nt"], Pair) and back["nt"].w is None
    assert torch.equal(back["nt"].idx, torch.tensor([7, 8]))
    assert isinstance(back["pair"], tuple)
    assert JaxManager(str(tmp_path)).manifest(2)["extra"] == {"segment": 2}


def test_checkpoint_snapshot_restore_device_and_errors(tmp_path):
    """The snapshot is taken at save time (a later in-place update does not
    reach the file); restore follows the template's dtype; an empty
    directory raises."""
    x = torch.ones(3)
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(0, {"x": x})
    x.add_(5.0)
    got = mgr.restore({"x": torch.zeros(3, dtype=torch.float16)})["x"]
    assert got.dtype == torch.float16
    assert torch.equal(got, torch.ones(3).half())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"x": x})


def test_age_ledger_round_trips_through_checkpoint(tmp_path):
    led = AgeLedger.fresh(5, 2, 3).advanced(7).elapsed(2.5) \
        .reset(np.eye(2, 3, dtype=bool))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"age": led}, blocking=True)
    keys = set(mgr.manifest()["leaves"])
    assert keys == {"['age'].mvms", "['age'].seconds",
                    "['age'].refresh_count", "['age'].fault_keys"}
    back = mgr.restore({"age": AgeLedger.fresh(0, 2, 3)})["age"]
    for f in ("mvms", "seconds", "refresh_count", "fault_keys"):
        assert torch.equal(getattr(back, f), getattr(led, f))
        assert getattr(back, f).dtype == getattr(led, f).dtype


def test_watchdog_flags_stragglers():
    hits = []
    wd = Watchdog(threshold=2.0, patience=2, on_straggler=hits.append)
    for step, s in enumerate([1.0] * 6 + [5.0, 5.0, 1.0, 5.0]):
        wd.record(step, s)
    assert wd.events == [6, 7, 9] and hits == [7]


# ---------------------------------------------------------------- refusals
def test_aged_execution_refused_off_the_reference_backend():
    """backend="cuda" raises for an aged handle and an aged group, in both
    directions, with no fallback to the reference backend."""
    a, x, _ = spd()
    _, pcfg = configs()
    A = AnalogEngine(pcfg, backend="cuda", device="cpu").program(a, 1)
    trel.attach_age(A)
    for call in (lambda: A @ torch.from_numpy(x),
                 lambda: A.T @ torch.from_numpy(x),
                 lambda: solvers.cg(A, x, maxiter=2)):
        with pytest.raises(ValueError, match="backend='reference'"):
            call()
    assert A.calls == 0 and float(A.age.mvms.max()) == 0.0
    geng = AnalogEngine(pcfg, backend="cuda", device="cpu")
    G = geng.program_group(torch.from_numpy(np.stack([a, a])), 2)
    attach_group_age(G)
    with pytest.raises(ValueError, match="backend='reference'"):
        geng.group_mvm(G, torch.from_numpy(x))
    with pytest.raises(ValueError, match="backend='reference'"):
        geng.group_rmvm(G, torch.from_numpy(x))


def test_streamed_and_distributed_handles_refuse_ages():
    a, x, _ = spd()
    _, pcfg = configs()
    blocks = torch.from_numpy(a).view(2, 64, 2, 64).transpose(1, 2)
    seng = AnalogEngine(pcfg, execution="streamed", device="cpu")
    S = seng.program(lambda i, j: blocks[i, j], 3, shape=a.shape)
    with pytest.raises(ValueError, match="attach_age"):
        trel.attach_age(S)
    with pytest.raises(ValueError, match="resident"):
        trel.refresh_tiles(S, np.ones((2, 2)), trel.RefreshPolicy(0.0))
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    deng = AnalogEngine(pcfg, execution="distributed", mesh=mesh)
    D = deng.program(a, 3)
    with pytest.raises(ValueError, match="attach_age"):
        trel.attach_age(D)
    # An age set by hand is refused at execute, not ignored.
    for h in (S, D):
        h.age = AgeLedger.fresh(0, 2, 2)
        with pytest.raises(ValueError, match="AgeLedger"):
            h @ torch.from_numpy(x)
    SG = seng.group([seng.program(lambda i, j: blocks[i, j], k,
                                  shape=a.shape) for k in (1, 2)])
    with pytest.raises(ValueError, match="attach_group_age"):
        attach_group_age(SG)
    DG = deng.program_group(torch.from_numpy(np.stack([a, a])), 4)
    with pytest.raises(ValueError, match="attach_group_age"):
        attach_group_age(DG)


def test_group_of_aged_members_and_chain_of_aged_group_refused():
    a, x, _ = spd()
    _, pcfg = configs()
    eng = AnalogEngine(pcfg, device="cpu")
    h = [eng.program(a, k) for k in (1, 2)]
    trel.attach_age(h[1])
    with pytest.raises(ValueError, match="attach_group_age"):
        eng.group(h)
    G = eng.group([h[0], eng.program(a, 3)])
    attach_group_age(G)
    with pytest.raises(ValueError, match="chain_mvm"):
        eng.chain_mvm(G, torch.from_numpy(x))


def test_chip_smoke_reliability_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 11 is a function with size arguments: at
    1,024^2 on the CPU (``reliability_probe.py rehearse``: synchronise and
    memory calls stubbed, the kernel wrappers counted) every check of
    [11a]-[11d] passes and each of its kernels is called."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(repo / "reliability_probe.py"), "rehearse",
         "--n", "1024"], text=True, capture_output=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("rehearsal at 1024^2 on the CPU passed")
    for name in ("ec_matmul", "ec_rmatmul", "stencil_denoise", "cg_update"):
        assert f"'{name}'" in last, name


def test_reference_replay_test_age_is_a_fragile_threshold():
    """tests/test_reliability.py::test_aged_blocks_replayable_and_monotone
    fails on a threshold, not on a broken ``aged_blocks``: at its age n1
    (0.5 expected faults) the reference's own ``aged_blocks`` with the
    test's handle latches no cell, so ``stuck1.sum() > 0`` cannot hold;
    at 4, 20 and 100 x n1 it latches 1, 7 and 25, growing with age.  The
    port's replay test ages to >= 20 expected faults for that reason."""
    from test_reliability import _handle, _spd
    a, _, _ = _spd(128)
    A = _handle(a, device="ag-si")
    led = jrel.attach_age(A)
    dev = A.engine.cfg.device
    n1 = int(0.5 / (dev.fault_rate * a.size))
    counts = [int(np.sum(np.abs(np.asarray(jaging.aged_blocks(
        A.at_blocks, led.advanced(k * n1), dev) - A.at_blocks)) > 1e-9))
        for k in (1, 4, 20, 100)]
    assert counts == [0, 1, 7, 25]
