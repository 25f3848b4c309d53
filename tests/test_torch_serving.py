"""The port's serving simulator held to the JAX package's on the CPU: the
traffic trace field for field, the request queue's batches, the image
cache's decisions under every policy (and the float32 near-tie of the
``write_cost`` ranking), the metrics, and ``simulate`` at
``run_model=False`` on two reduced rwkv6 tenants under eviction, the same
trace on the digital baseline, and the refresh scheduler on two zamba2
tenants.

Order, request ids, batch membership, evicted keys and every counter must
be equal; the simulated times and joules within rel 1e-6 (the reference
sums its write costs in float32, the port in float64: ~1e-7 apart).  The
two dispatch keys differ by design: the port counts a prefill and one call
a decode step (``Server.dispatches_per_batch``), the reference one fused
decode scan; each is checked against its own formula."""
import dataclasses
import gc
import inspect
import math
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401
import repro.serving as R
from repro.configs.base import RRAMBackendConfig as JRRAMBackendConfig
from repro.core.write_verify import WriteStats as JWriteStats
from repro.serving import simulator as jsim
import repro_torch.serving as T
from repro_torch.configs import get_arch, model_module
from repro_torch.configs.base import RRAMBackendConfig
from repro_torch.core.write_verify import WriteStats
from repro_torch.models import params as PM
from repro_torch.models.rram import analog_image_bytes
from repro_torch.serving import simulator as psim
from repro_torch.train.serve import Server

FLOAT_REL = 1e-6
DISPATCH_KEYS = ("exec_dispatches", "dispatches_per_batch")
# Below two reduced rwkv6 images (688,128 B each): the trace of
# ``_two_tenant_cfg`` evicts and reprograms.
TWO_TENANT_CAPACITY = 1_000_000


def _astuple(x):
    return tuple(getattr(x, f.name) for f in dataclasses.fields(x))


def assert_close(got, want, path=""):
    """Equal, but floats within FLOAT_REL relative."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_close(got[k], want[k], f"{path}/{k}")
    elif dataclasses.is_dataclass(want):
        assert_close(dataclasses.asdict(got), dataclasses.asdict(want), path)
    elif isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(float(want), rel=FLOAT_REL, abs=0.0), \
            (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# ---------------------------------------------------------------- traffic

TENANT_NAMES = (("a", "rwkv6-1.6b"), ("b", "qwen3-1.7b"),
                ("c", "rwkv6-1.6b"), ("d", "zamba2-1.2b"))
TRAFFIC = [
    dict(n_requests=200, zipf_s=1.3),
    dict(n_requests=64),
    dict(n_requests=50, rate_rps=50.0, zipf_s=0.0, prompt_lens=(4, 10),
         prompt_mix=(0.5, 0.5), decode_lens=(3, 7), decode_mix=(0.5, 0.5)),
    dict(n_requests=37, rate_rps=0.5, zipf_s=2.5, prompt_lens=(6, 12, 20),
         prompt_mix=(3.0, 1.0, 1.0), decode_lens=(4, 8), decode_mix=(0.6,
                                                                     0.4)),
]


def _tenants(mod, n=3):
    return tuple(mod.TenantSpec(name, arch) for name, arch in
                 TENANT_NAMES[:n])


@pytest.mark.parametrize("seed", [0, 11, 2024])
@pytest.mark.parametrize("kw", TRAFFIC, ids=["zipf1.3", "defaults",
                                             "uniform", "skewed"])
def test_trace_equals_the_reference(kw, seed):
    for n in (1, 3, 4):
        want = R.generate_trace(_tenants(R, n), R.TrafficConfig(**kw,
                                                                seed=seed))
        got = T.generate_trace(_tenants(T, n), T.TrafficConfig(**kw,
                                                               seed=seed))
        assert len(got) == kw["n_requests"]
        assert [_astuple(r) for r in got] == [_astuple(r) for r in want]
        assert [type(v) for v in _astuple(got[0])] == \
            [type(v) for v in _astuple(want[0])]
    np.testing.assert_array_equal(T.zipf_weights(5, 1.1),
                                  R.zipf_weights(5, 1.1))
    with pytest.raises(ValueError):
        T.generate_trace((), T.TrafficConfig())


# --------------------------------------------------------------- batching

BATCHING = [
    dict(max_batch=4, prompt_buckets=(4, 16), decode_buckets=(4, 8),
         batch_buckets=(1, 2, 4)),
    dict(max_batch=3, prompt_buckets=(8, 16, 32), decode_buckets=(4, 8, 16),
         batch_buckets=(1, 2, 4, 8)),
]


def _batches(mod, trace, bkw, service_s):
    q = mod.RequestQueue(mod.BatchingConfig(**bkw))
    for r in trace:
        q.add(r)
    now, out = 0.0, []
    while len(q):
        b = q.form_batch(now)
        if b is None:
            nxt = q.next_arrival(now)
            out.append(("idle", now, nxt))
            now = nxt
            continue
        out.append((tuple(r.rid for r in b.requests), b.tenant, b.arch,
                    b.prompt_bucket, b.decode_bucket, b.batch_pad, b.size,
                    b.useful_prompt_tokens, b.useful_decode_tokens,
                    b.padded_prompt_tokens, b.padded_decode_tokens,
                    len(q)))
        now += service_s
    return out


@pytest.mark.parametrize("service_s", [0.05, 1.0])
@pytest.mark.parametrize("bi", range(len(BATCHING)))
def test_request_queue_forms_the_reference_batches(bi, service_s):
    kw = dict(n_requests=80, rate_rps=50.0, zipf_s=1.2, prompt_lens=(4, 10),
              prompt_mix=(0.5, 0.5), decode_lens=(3, 7),
              decode_mix=(0.5, 0.5), seed=3)
    bkw = BATCHING[bi]
    want = _batches(R, R.generate_trace(_tenants(R), R.TrafficConfig(**kw)),
                    bkw, service_s)
    got = _batches(T, T.generate_trace(_tenants(T), T.TrafficConfig(**kw)),
                   bkw, service_s)
    assert got == want
    assert sum(1 for b in got if b[0] != "idle" and b[6] > 1) > 0


def test_batching_validation_and_buckets():
    for mod in (R, T):
        assert mod.bucket_for(5, (4, 8, 16)) == 8
        assert mod.bucket_for(4, (4, 8, 16)) == 4
        with pytest.raises(ValueError):
            mod.bucket_for(20, (4, 8, 16))
        with pytest.raises(ValueError):
            mod.BatchingConfig(prompt_buckets=(16, 8))
        with pytest.raises(ValueError):
            mod.BatchingConfig(max_batch=16)
    assert _astuple(T.BatchingConfig()) == _astuple(R.BatchingConfig())
    assert _astuple(T.TrafficConfig()) == _astuple(R.TrafficConfig())


# ------------------------------------------------------------------ cache

# Energies and latencies exact in float32, so the reference's float32
# write stats and the port's Python floats hold the same values.
ENERGIES = (0.125, 0.25, 0.5, 1.0, 2.0, 4.0)
LATENCIES = (0.0078125, 0.015625, 0.03125)


def _fake(mod, size, energy, latency):
    if mod is R:
        def build():
            return object(), size, JWriteStats(
                energy_j=jnp.float32(energy), latency_s=jnp.float32(latency),
                iterations=jnp.int32(1), final_delta=jnp.float32(0.0))
    else:
        def build():
            return object(), size, WriteStats(
                energy_j=energy, latency_s=latency, iterations=1,
                final_delta=0.0)
    return build


def _cache_run(mod, policy, seed):
    """A seeded random access sequence (plus in-place refreshes of resident
    entries) through one cache; returns every step's observable."""
    rng = np.random.Generator(np.random.PCG64(seed))
    n_keys = 6
    sizes = rng.integers(100, 500, size=n_keys)
    energy = [ENERGIES[i] for i in rng.integers(0, len(ENERGIES), n_keys)]
    latency = [LATENCIES[i] for i in rng.integers(0, len(LATENCIES), n_keys)]
    cache = mod.ImageCache(1000, policy, tau_s=float(rng.choice([5.0, 30.0])))
    log, t = [], 0.0
    hot = rng.dirichlet(np.ones(n_keys) * 0.5)
    for step in range(60):
        t += float(rng.exponential(2.0))
        key = f"k{int(rng.choice(n_keys, p=hot))}"
        if rng.random() < 0.1 and cache.entries:
            rk = sorted(cache.entries)[int(rng.integers(len(cache.entries)))]
            cache.note_refresh(rk, _fake(mod, 1, 0.0625, 0.0078125)()[2])
            log.append(("refresh", rk))
        i = int(key[1:])
        try:
            _, out = cache.get(key, _fake(mod, int(sizes[i]), energy[i],
                                          latency[i]), t)
            log.append((key, out.hit, out.reprogrammed, out.evicted,
                        float(out.write_stats.energy_j),
                        float(out.write_stats.latency_s)))
        except mod.CacheOverBudgetError:
            log.append((key, "over budget"))
        log.append((cache.used_bytes, tuple(sorted(
            (k, e.hits, e.last_used_s, e.size_bytes)
            for k, e in cache.entries.items()))))
    with pytest.raises(KeyError):
        cache.note_refresh("absent", _fake(mod, 1, 1.0, 1.0)()[2])
    return log, cache.stats()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", ["lru", "never", "write_cost"])
def test_image_cache_decides_as_the_reference(policy, seed):
    want_log, want_stats = _cache_run(R, policy, seed)
    got_log, got_stats = _cache_run(T, policy, seed)
    assert got_log == want_log
    assert got_stats == want_stats
    if policy == "never":
        assert any(s[1:] == ("over budget",) for s in got_log
                   if len(s) == 2 and isinstance(s[1], str))
    else:
        assert got_stats["evictions"] > 0 and got_stats["reprograms"] > 0


def test_cache_rejects_an_entry_over_capacity_and_unknown_policies():
    for mod in (R, T):
        with pytest.raises(mod.CacheOverBudgetError):
            mod.ImageCache(100, "lru").get("x", _fake(mod, 500, 1.0, 0.5),
                                           0.0)
        with pytest.raises(ValueError):
            mod.ImageCache(100, "fifo")
    assert T.POLICIES == R.POLICIES


def _near_tie(mod, s, now):
    """A (hit at 0 and 1) and B (one hit at ``s``) resident, equal energy;
    C's admission at ``now`` evicts one of them."""
    cache = mod.ImageCache(2, "write_cost")
    cache.get("A", _fake(mod, 1, 1.0, 0.5), 0.0)
    cache.get("A", _fake(mod, 1, 1.0, 0.5), 1.0)
    cache.get("B", _fake(mod, 1, 1.0, 0.5), s)
    return cache


def test_write_cost_ranks_near_ties_in_float32_as_the_reference():
    """A's decayed rate (1 + e^-1/tau) e^-(now-1)/tau and B's
    e^-(now-s)/tau are set ~1e-9 apart, B's below: a float64 ranking
    evicts B, the reference's float32 product ties them and the tie goes
    to the older entry, A.  The port must evict A."""
    tau = 30.0
    s_tie = 1.0 + tau * math.log1p(math.exp(-1.0 / tau))
    case = None
    for j in range(1, 200):
        s = s_tie - j * 1e-8
        for now in (s + 1.0, s + 2.5, s + 7.0):
            c = _near_tie(T, s, now)
            ra = c.entries["A"].hit_rate(now, tau)
            rb = c.entries["B"].hit_rate(now, tau)
            if rb < ra and np.float32(ra) == np.float32(rb):
                case = (s, now)
                break
        if case:
            break
    assert case is not None
    s, now = case
    port, ref = _near_tie(T, s, now), _near_tie(R, s, now)
    f64 = min(port.entries.values(),
              key=lambda e: (e.write_stats.energy_j * e.hit_rate(now, tau),
                             e.last_used_s, str(e.key))).key
    assert f64 == "B"
    _, want = ref.get("C", _fake(R, 1, 1.0, 0.5), now)
    _, got = port.get("C", _fake(T, 1, 1.0, 0.5), now)
    assert want.evicted == ("A",)
    assert got.evicted == want.evicted
    assert sorted(port.entries) == sorted(ref.entries) == ["B", "C"]


# ---------------------------------------------------------------- metrics

def test_percentile_and_digital_cost():
    rng = np.random.default_rng(4)
    for n in (0, 1, 2, 7, 100):
        vals = list(rng.standard_normal(n))
        for q in (0.0, 50.0, 99.0, 99.9, 100.0):
            assert T.percentile(vals, q) == R.percentile(vals, q)
    for n_params, tokens in ((1, 1), (125_000, 64), (1_720_000_000, 4)):
        assert T.digital_cost(n_params, tokens) == \
            R.digital_cost(n_params, tokens)
    assert (T.DIGITAL_J_PER_FLOP, T.DIGITAL_FLOPS_PER_S) == \
        (R.DIGITAL_J_PER_FLOP, R.DIGITAL_FLOPS_PER_S)


@pytest.mark.parametrize("with_cache", [False, True])
def test_metrics_summary_equals_the_reference(with_cache):
    rng = np.random.default_rng(7)
    accs = (R.MetricsAccumulator(), T.MetricsAccumulator())
    for i in range(30):
        arr = float(rng.uniform(0, 10))
        start = arr + float(rng.uniform(0, 2))
        rec = dict(rid=i, tenant=f"t{i % 3}", arch="rwkv6-1.6b",
                   arrival_s=arr, start_s=start,
                   finish_s=start + float(rng.uniform(0.1, 3)),
                   prompt_len=int(rng.integers(4, 32)),
                   decode_len=int(rng.integers(1, 16)),
                   energy_j=float(rng.uniform(0, 1e-3)))
        batch = (float(rng.uniform(0, 1e-2)), int(rng.integers(1, 50)),
                 int(rng.integers(50, 90)), int(rng.integers(1, 9)))
        for mod, acc in zip((R, T), accs):
            acc.add_record(mod.RequestRecord(**rec))
            acc.add_batch(*batch)
            if i % 4 == 0:
                acc.add_program_dispatches(5)
                acc.add_health(0.01 * i)
            if i % 7 == 0:
                acc.add_refresh(1e-4 * i, 0.5 * i)
    stats = {"policy": "lru", "write_energy_j": 0.0123, "hits": 3} \
        if with_cache else None
    assert accs[1].summary(stats) == accs[0].summary(stats)
    assert [r.latency_s for r in accs[1].records] == \
        [r.latency_s for r in accs[0].records]
    assert T.MetricsAccumulator().summary() == R.MetricsAccumulator().summary()


# -------------------------------------------------------------- simulate

def _two_tenant_cfg(mod, rram, **kw):
    """test_serving.py's two rwkv6 tenants, 8 requests, below two images."""
    tenants = (mod.TenantSpec("acme", "rwkv6-1.6b"),
               mod.TenantSpec("initech", "rwkv6-1.6b"))
    traffic = mod.TrafficConfig(n_requests=8, rate_rps=6.0, zipf_s=1.0,
                                prompt_lens=(4, 8), prompt_mix=(0.6, 0.4),
                                decode_lens=(3, 5), decode_mix=(0.6, 0.4),
                                seed=2)
    base = dict(tenants=tenants, traffic=traffic,
                batching=mod.BatchingConfig(max_batch=2,
                                            prompt_buckets=(4, 8),
                                            decode_buckets=(4, 8),
                                            batch_buckets=(1, 2)),
                rram=rram, cache_capacity_bytes=TWO_TENANT_CAPACITY,
                policy="write_cost", seed=0, max_len=32, run_model=False)
    return mod.ServingConfig(**(base | kw))


def _refresh_cfg(mod, rram_cls):
    """test_reliability.py's refresh scheduler: two zamba2 tenants, ag-si."""
    tenants = (mod.TenantSpec("a", "zamba2-1.2b"),
               mod.TenantSpec("b", "zamba2-1.2b"))
    return mod.ServingConfig(
        tenants=tenants, traffic=mod.TrafficConfig(n_requests=16,
                                                   rate_rps=4.0, seed=3),
        rram=rram_cls(enabled=True, device="ag-si", k_iters=3),
        run_model=False,
        reliability=mod.ReliabilityConfig(refresh_threshold=0.05,
                                          refresh_fraction=0.25))


CASES = {
    "evicting": (lambda: _two_tenant_cfg(R, JRRAMBackendConfig(enabled=True)),
                 lambda: _two_tenant_cfg(T, RRAMBackendConfig(enabled=True))),
    "digital": (lambda: _two_tenant_cfg(R, None),
                lambda: _two_tenant_cfg(T, None)),
    "refresh": (lambda: _refresh_cfg(R, JRRAMBackendConfig),
                lambda: _refresh_cfg(T, RRAMBackendConfig)),
}


@pytest.fixture(scope="module")
def sims():
    """Each case once in each package (the reference's run is seconds of
    compiling its programming)."""
    return {name: (R.simulate(ref()), T.simulate(port(), device="cpu"))
            for name, (ref, port) in CASES.items()}


def _batches_of(res):
    """Batches as the records show them: members share a start time."""
    groups = {}
    for r in res.records:
        groups.setdefault(r.start_s, []).append(r)
    return [groups[k] for k in sorted(groups)]


@pytest.mark.parametrize("case", list(CASES))
def test_simulate_equals_the_reference(sims, case):
    ref, port = sims[case]
    cfg = CASES[case][1]()
    assert [r.rid for r in port.records] == [r.rid for r in ref.records]
    assert [[r.rid for r in b] for b in _batches_of(port)] == \
        [[r.rid for r in b] for b in _batches_of(ref)]
    for got, want in zip(port.records, ref.records):
        assert_close(got, want, f"rid {want.rid}")
    assert_close(port.cache_stats, ref.cache_stats)
    want = {k: v for k, v in ref.summary.items() if k not in DISPATCH_KEYS}
    got = {k: v for k, v in port.summary.items() if k not in DISPATCH_KEYS}
    assert_close(got, want)
    # The dispatch keys, each by its own package's formula: the reference
    # one prefill + one fused decode scan a batch, the port a prefill + one
    # call a decode step (the batch's decode bucket).
    n_batches = ref.summary["n_batches"]
    assert len(_batches_of(ref)) == n_batches
    buckets = [T.bucket_for(max(r.decode_len for r in b),
                            cfg.batching.decode_buckets)
               for b in _batches_of(port)]
    assert ref.summary["exec_dispatches"] == 2 * n_batches
    assert port.summary["exec_dispatches"] == sum(buckets)
    assert port.summary["dispatches_per_batch"] == sum(buckets) / n_batches
    if case == "evicting":
        cs = port.cache_stats
        assert cs["evictions"] >= 1 and cs["reprograms"] >= 1
    if case == "refresh":
        assert port.summary["reliability"]["refreshes"] > 0


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b",
                                  "qwen3-1.7b"])
def test_digital_param_count_equals_the_reference(arch):
    assert psim._digital_params(arch, 0, torch.device("cpu"))[3] == \
        jsim._digital_params(arch, 0)[3]


def test_simulate_replays_and_runs_the_model_to_the_same_metrics():
    """Two runs in one process replay each other; serving the model
    (``run_model=True``: every batch through ``Server.generate`` on the
    CPU) moves no metric."""
    cfg = _two_tenant_cfg(T, RRAMBackendConfig(enabled=True))
    r1 = T.simulate(cfg, device="cpu")
    r2 = T.simulate(cfg, device="cpu")
    assert r1.records == r2.records and r1.summary == r2.summary
    served = T.simulate(dataclasses.replace(cfg, run_model=True),
                        device="cpu")
    assert served.records == r1.records and served.summary == r1.summary
    assert served.cache_stats["reprograms"] >= 1


def test_evicted_image_is_freed_and_weights_are_shared():
    """An evicted tenant's image is held by nothing once the caller drops
    its Server; every tenant's Server shares the arch's digital weights."""
    cfg = _two_tenant_cfg(T, RRAMBackendConfig(enabled=True))
    fleet = psim._Fleet(cfg, torch.device("cpu"))
    srv, out = fleet.acquire("acme", 0.0)
    assert not out.hit and srv.program_dispatches > 0
    nbytes = analog_image_bytes(srv.params)
    assert nbytes > 0
    images = [weakref.ref(v) for p, v in PM.tree_paths(srv.params)
              if p.endswith("['w_tilde']") or p.endswith("['dw']")]
    assert len(images) > 2
    digital = fleet.arch_state("rwkv6-1.6b")[2]
    shared = {id(t) for _, t in PM.tree_paths(digital)}
    assert all(id(t) in shared for p, t in PM.tree_paths(srv.params)
               if not p.endswith("['w_tilde']") and not p.endswith("['dw']"))
    srv2, out2 = fleet.acquire("acme", 1.0)
    assert out2.hit and srv2 is srv and out2.write_stats == WriteStats.zero()
    del srv, srv2
    other, out3 = fleet.acquire("initech", 2.0)
    assert out3.evicted == ("acme",)
    gc.collect()
    assert all(ref() is None for ref in images)
    assert fleet.cache.used_bytes == analog_image_bytes(other.params)


@pytest.mark.parametrize("group", [True, False])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b"])
def test_write_stats_on_shapes_equal_the_programmed_models(arch, group):
    """``programming_write_stats`` and ``analog_image_bytes`` of a programmed
    tree of meta tensors equal what ``program_rram`` bills and allocates
    for the real model: a cache schedule replays on shapes alone."""
    from repro_torch.models.rram import (crossbar_cfg, program_rram,
                                         program_specs,
                                         programming_write_stats)
    cfg = get_arch(arch).reduced()
    mod = model_module(cfg)
    rram = RRAMBackendConfig(enabled=True, cell_rows=32, cell_cols=32)
    prm = PM.materialize(mod.init_specs(cfg), 0, torch.float32, "cpu")
    prog, stats = program_rram(prm, rram, 3, group=group)
    meta = PM.tree_map(
        lambda s: torch.empty(s.shape, device="meta", dtype=PM.torch_dtype(
            s.dtype or "float32")),
        program_specs(mod.init_specs(cfg), rram))
    assert programming_write_stats(meta, crossbar_cfg(rram),
                                   group=group) == stats
    assert analog_image_bytes(meta) == analog_image_bytes(prog) > 0


def test_server_dispatches_per_batch_counts_step_calls():
    cfg = get_arch("rwkv6-1.6b").reduced()
    mod = model_module(cfg)
    prm = PM.materialize(mod.init_specs(cfg), 0, torch.float32, "cpu")
    srv = Server(mod, cfg, prm, max_len=16)
    calls = [0]
    real = mod.decode_step

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    tokens = torch.zeros((2, 4), dtype=torch.int32)
    for n in (1, 2, 5):
        calls[0] = 0
        mod.decode_step = counting
        try:
            out = srv.generate({"tokens": tokens}, n)
        finally:
            mod.decode_step = real
        assert tuple(out.shape) == (2, n)
        assert srv.dispatches_per_batch(n) == n == 1 + calls[0]


def test_simulate_runs_on_the_card_unless_told_cpu(monkeypatch):
    assert inspect.signature(T.simulate).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _two_tenant_cfg(T, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.simulate(cfg)
    assert [f.name for f in dataclasses.fields(T.ServingConfig)] == \
        [f.name for f in dataclasses.fields(R.ServingConfig)]
    assert T.__all__ == R.__all__
