"""The registry of pipelines the invariant audits run over (of
:mod:`repro.analysis.pipelines`).

Every claim-bearing execution path of the engine -- placement (local /
streamed / distributed) x pipeline (MVM / solve) x direction (forward /
rmatvec) x backend (``reference`` / ``cuda``), grouped images, the aged
image, the solver cores and the serving decode -- is registered here as a
:class:`PipelineSpec` under the reference's name (``pallas`` read as
``cuda``), with its build functions, shapes, seeds, key 7 and budgets.
``build()`` programs what the pipeline needs and returns a
:class:`BuiltPipeline`: a callable, its concrete arguments, the producer's
:class:`~repro_torch.analysis.verify.CallCounter` and what reads the
handle's MVM count.
:func:`verify_pipeline` runs it once under the five passes of
:mod:`repro_torch.analysis.verify` (the reference traces it; nothing of it
runs there).

Scales (:func:`registered_pipelines`):

* ``"paper"``: the reference's sizes.  The six ``virtual65536`` entries run
  a 65,536^2 banded producer ``resident=False`` on taox-hfox 4 x 4 MCAs of
  512^2: 1,024 capacity blocks of 2,048^2 an MVM, none resident.
* ``"cpu"``: every small entry as it is; the virtual entries at n = 512 on
  the small configuration's 64^2 blocks (64 blocks), ``resident=False``, on
  the same 1 x 1 and 2 x 4 meshes.

At both scales the two virtual solves stop at :data:`ANALYSIS_MAXITER`
iterations (the reference's 100 and 50): a run executes every iteration,
where the reference's trace executes none.  Every entry runs on one device;
the 2 x 4 mesh is eight ranks on one device, so ``min_devices`` is kept
only for the manifest's shape (it is the reference's device count).

:func:`check_section` runs :func:`verify_pipeline` over the registry at
a device's scale (:data:`SCALE_OF`: the card the paper's, the CPU the
reduced one) and compares each :func:`manifest_record` with the section of
``INVARIANTS_torch.json`` named for the device's type;
``tools/check_invariants_torch.py`` and ``chip_smoke.py``'s phase [18]
print and check what it returns.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import CrossbarConfig, MCAGeometry, get_device
from ..core.matrices import ImplicitBandedMatrix
from ..engine import AnalogEngine
from ..launch.mesh import make_mesh
from . import verify as V

#: virtual paper-scale operator: n^2 = 4.29e9 elements, never materialized
VIRTUAL_N = 65_536
VIRTUAL_CAP = 2_048
#: the virtual operator at ``scale="cpu"``: 64 blocks of the small 64^2
CPU_VIRTUAL_N = 512
#: iterations of the two virtual solves at either scale
ANALYSIS_MAXITER = 2
KEY = 7
SCALES = ("paper", "cpu")
#: the scale each device type runs the registry at; the manifest's section
#: for a device is named for its type
SCALE_OF = {"cuda": "paper", "cpu": "cpu"}


@dataclasses.dataclass
class BuiltPipeline:
    """A runnable pipeline: callable + arguments (+ producer counter)."""

    fn: Callable
    args: Tuple[Any, ...]
    producer: Optional[V.CallCounter] = None
    allowed_axes: Tuple[str, ...] = ()
    #: reads the handle's executed MVMs (its change over the run counts)
    mvms: Optional[Callable[[], int]] = None
    #: position of the key argument (None: the call takes none)
    key_arg: Optional[int] = -1


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """One registered placement x pipeline x direction x backend config."""

    name: str
    placement: str            # local | streamed | distributed
    direction: str            # forward | rmatvec | solve | decode
    backend: str              # reference | cuda
    build: Callable[[], BuiltPipeline]
    device: torch.device
    min_devices: int = 1
    aval_budget: int = 0
    #: kernel launches a run may make (None: no budget)
    max_launches: Optional[int] = None
    #: blocks of the producer's grid: at most one call a block an MVM
    producer_per_mvm: Optional[int] = None
    per_device_budget: Optional[int] = None
    allow_baked: bool = False
    #: the iterations a solve's build was given (None: not a solve)
    maxiter: Optional[int] = None

    @property
    def virtual(self) -> bool:
        """Runs the virtual ``resident=False`` operator."""
        return "virtual65536" in self.name


def _randn(shape, seed: int, device, scale: float = 1.0) -> torch.Tensor:
    """A float32 normal tensor from numpy's generator ``seed`` (the same
    numbers on every device)."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a / np.float32(scale)).to(device)


def _vec(n: int, device, batch: Optional[int] = None) -> torch.Tensor:
    return _randn((n,) if batch is None else (n, batch), KEY + 1, device)


def _small_cfg():
    return CrossbarConfig(device=get_device("taox-hfox"),
                          geom=MCAGeometry(2, 2, 32, 32), k_iters=5, ec=True)


def _virtual_cfg():
    return CrossbarConfig(device=get_device("taox-hfox"),
                          geom=MCAGeometry(4, 4, 512, 512), k_iters=5,
                          ec=True)


def _virtual(scale: str):
    """(config, n, cap) of the virtual operator at ``scale``."""
    if scale == "paper":
        return _virtual_cfg(), VIRTUAL_N, VIRTUAL_CAP
    cfg = _small_cfg()
    return cfg, CPU_VIRTUAL_N, cfg.geom.capacity[0]


def _mesh(shape: Tuple[int, int], device):
    return make_mesh(shape, ("data", "model"), device=device)


def _banded(n: int, cap: int, device, seed: int = 2):
    return ImplicitBandedMatrix(n=n, cap_m=cap, cap_n=cap, seed=seed,
                                device=device)


def _build_local(device, backend: str, transpose: bool) -> BuiltPipeline:
    engine = AnalogEngine(_small_cfg(), device=device, backend=backend)
    a = _randn((100, 90), KEY, device, 10)
    A = engine.program(a, KEY)
    n_in = a.shape[0] if transpose else a.shape[1]
    return BuiltPipeline(fn=engine.mvm_fn(A, transpose=transpose),
                         args=(_vec(n_in, device), KEY),
                         mvms=lambda: A.calls)


def _build_local_aged(device) -> BuiltPipeline:
    """Local reference forward MVM with an ``AgeLedger`` attached: drift and
    replayable stuck-at faults applied to the image inside the execute."""
    from ..reliability.aging import attach_age
    engine = AnalogEngine(_small_cfg(), device=device, backend="reference")
    a = _randn((100, 90), KEY, device, 10)
    A = engine.program(a, KEY)
    attach_age(A)
    A.age = A.age.advanced(1_000).elapsed(3600.0)   # a visibly aged image
    return BuiltPipeline(fn=engine.mvm_fn(A),
                         args=(_vec(a.shape[1], device), KEY),
                         mvms=lambda: A.calls)


def _build_group(device, backend: str, transpose: bool) -> BuiltPipeline:
    """Eight same-geometry images stacked by ``program_group`` and executed
    as one group call."""
    engine = AnalogEngine(_small_cfg(), device=device, backend=backend)
    stack = _randn((8, 100, 90), KEY, device, 10)
    G = engine.program_group(stack, KEY)
    n_in = stack.shape[1] if transpose else stack.shape[2]
    return BuiltPipeline(fn=engine.group_mvm_fn(G, transpose=transpose),
                         args=(_vec(n_in, device), KEY),
                         mvms=lambda: G.calls)


def _build_group_moe(device) -> BuiltPipeline:
    """Eight MoE expert kernels -- a dict, not a stacked array -- grouped
    into one image and executed as one group call."""
    engine = AnalogEngine(_small_cfg(), device=device, backend="reference")
    stack = _randn((8, 64, 128), KEY, device, 10)
    experts = {f"expert_{g}": stack[g] for g in range(stack.shape[0])}
    G = engine.program_group(experts, KEY)
    return BuiltPipeline(fn=engine.group_mvm_fn(G),
                         args=(_vec(stack.shape[2], device), KEY),
                         mvms=lambda: G.calls)


def _build_chain(device, backend: str) -> BuiltPipeline:
    """The whole-model analog forward: eight square layers chained with a
    relu between members (``engine.chain_mvm``)."""
    engine = AnalogEngine(_small_cfg(), device=device, backend=backend)
    stack = _randn((8, 96, 96), KEY, device, 10)
    G = engine.program_group(stack, KEY)
    return BuiltPipeline(fn=engine.chain_fn(G, activation="relu"),
                         args=(_vec(stack.shape[2], device), KEY),
                         mvms=lambda: G.calls)


def _streamed_handle(device, backend: str = "reference"):
    """The small streamed producer handle: n = 256, a 4 x 4 grid of 64^2."""
    cfg = _small_cfg()
    cap = cfg.geom.capacity[0]
    n = 4 * cap
    engine = AnalogEngine(cfg, device=device, execution="streamed",
                          backend=backend)
    producer = V.CallCounter(_banded(n, cap, device).block)
    A = engine.program(producer, KEY, shape=(n, n))
    return engine, A, producer, n


def _build_streamed(device, backend: str, transpose: bool) -> BuiltPipeline:
    engine, A, producer, n = _streamed_handle(device, backend)
    return BuiltPipeline(fn=engine.mvm_fn(A, transpose=transpose),
                         args=(_vec(n, device), KEY), producer=producer,
                         mvms=lambda: A.calls)


def _build_distributed_dense(device, transpose: bool,
                             mesh_shape: Tuple[int, int]) -> BuiltPipeline:
    cfg = _small_cfg()
    cap = cfg.geom.capacity[0]
    n = 2 * cap * max(mesh_shape)                    # divides every mesh dim
    engine = AnalogEngine(cfg, device=device, execution="distributed",
                     mesh=_mesh(mesh_shape, device))
    A = engine.program(_randn((n, n), KEY, device, n), KEY)
    return BuiltPipeline(fn=engine.mvm_fn(A, transpose=transpose),
                         args=(_vec(n, device), KEY),
                         allowed_axes=engine.collective_axes,
                         mvms=lambda: A.calls)


def _virtual_handle(device, scale: str, mesh_shape: Tuple[int, int]):
    """The virtual producer operator, ``resident=False``: programming calls
    the producer nowhere."""
    cfg, n, cap = _virtual(scale)
    engine = AnalogEngine(cfg, device=device, execution="distributed",
                     mesh=_mesh(mesh_shape, device))
    producer = V.CallCounter(_banded(n, cap, device).block)
    A = engine.program(producer, KEY, shape=(n, n), resident=False)
    assert producer.calls == 0, "resident=False programming ran the producer"
    return engine, A, producer, n


def _build_virtual(device, scale: str, transpose: bool,
                   mesh_shape: Tuple[int, int]) -> BuiltPipeline:
    """The paper-scale distributed ``resident=False`` producer MVM."""
    engine, A, producer, n = _virtual_handle(device, scale, mesh_shape)
    return BuiltPipeline(fn=engine.mvm_fn(A, transpose=transpose),
                         args=(_vec(n, device), KEY), producer=producer,
                         allowed_axes=engine.collective_axes,
                         mvms=lambda: A.calls)


def _build_cg(device, *, maxiter: int) -> BuiltPipeline:
    from ..solvers import as_operator, cg_pipeline
    _, A, producer, n = _streamed_handle(device)
    core = cg_pipeline(as_operator(A), tol=1e-5, maxiter=maxiter)
    return BuiltPipeline(fn=core, args=(_vec(n, device, 1),
                                        torch.zeros(n, 1, device=device), KEY),
                         producer=producer, mvms=lambda: A.calls)


def _build_pdhg(device, scale: str, mesh_shape: Tuple[int, int], *,
                maxiter: int) -> BuiltPipeline:
    """The PDHG LP core over the virtual operator."""
    from ..solvers import as_operator, pdhg_pipeline
    engine, A, producer, n = _virtual_handle(device, scale, mesh_shape)
    core = pdhg_pipeline(as_operator(A), tau=0.1, sigma=0.1, tol=1e-4,
                         maxiter=maxiter)
    zeros = torch.zeros(n, 1, device=device)
    return BuiltPipeline(
        fn=core, args=(_vec(n, device, 1), _randn((n, 1), KEY + 2, device),
                       zeros, zeros, KEY),
        producer=producer, allowed_axes=engine.collective_axes,
        mvms=lambda: A.calls)


def _build_lsqr(device, *, maxiter: int) -> BuiltPipeline:
    """The LSQR least-squares core over the small streamed producer."""
    from ..solvers import as_operator, lsqr_pipeline
    _, A, producer, n = _streamed_handle(device)
    core = lsqr_pipeline(as_operator(A), tol=1e-5, maxiter=maxiter)
    return BuiltPipeline(fn=core, args=(_vec(n, device, 1),
                                        torch.zeros(n, 1, device=device), KEY),
                         producer=producer, mvms=lambda: A.calls)


def _build_lanczos(device, *, maxiter: int) -> BuiltPipeline:
    """The Lanczos extremal-eigenpair sweep (power-iteration seed
    included) over the small streamed producer; ``(key)`` in."""
    from ..solvers import as_operator, lanczos_pipeline
    _, A, producer, _ = _streamed_handle(device)
    core = lanczos_pipeline(as_operator(A), tol=1e-4, maxiter=maxiter)
    return BuiltPipeline(fn=core, args=(KEY,), producer=producer,
                         mvms=lambda: A.calls)


def _build_admm(device, *, maxiter: int) -> BuiltPipeline:
    """The linearized-ADMM box-QP core (one matvec + one rmatvec an
    iteration, the power-iteration step estimate included) over the small
    streamed producer."""
    from ..solvers import admm_pipeline, as_operator
    _, A, producer, n = _streamed_handle(device)
    ones = torch.ones(n, device=device)
    core = admm_pipeline(as_operator(A), lo=-ones, hi=ones, tol=1e-4,
                         maxiter=maxiter)
    return BuiltPipeline(
        fn=core, args=(_vec(n, device, 1), _randn((n, 1), KEY + 2, device),
                       torch.zeros(n, 1, device=device), KEY),
        producer=producer, mvms=lambda: A.calls)


def _build_lstsq_virtual(device, scale: str, mesh_shape: Tuple[int, int], *,
                         maxiter: int) -> BuiltPipeline:
    """LSQR over the virtual ``resident=False`` operator on the mesh."""
    from ..solvers import as_operator, lsqr_pipeline
    engine, A, producer, n = _virtual_handle(device, scale, mesh_shape)
    core = lsqr_pipeline(as_operator(A), tol=1e-4, maxiter=maxiter)
    return BuiltPipeline(fn=core, args=(_vec(n, device, 1),
                                        torch.zeros(n, 1, device=device), KEY),
                         producer=producer,
                         allowed_axes=engine.collective_axes,
                         mvms=lambda: A.calls)


def _build_serving_decode(device) -> BuiltPipeline:
    """The serving decode hot path: an analog LM Server's 8-token greedy
    decode (``Server.decode_fn``), two sequences, caches written in
    place."""
    from ..configs.base import RRAMBackendConfig
    from ..configs.registry import get_arch, model_module
    from ..models import params as P
    from ..models.common import Runtime
    from ..train.serve import Server
    cfg = get_arch("rwkv6-1.6b").reduced()
    mod = model_module(cfg)
    prm = P.materialize(mod.init_specs(cfg), KEY, torch.float32,
                        device=device)
    srv = Server(mod, cfg, prm,
                 rt=Runtime(rram=RRAMBackendConfig(enabled=True)),
                 max_len=32, key=KEY)
    caches = mod.init_caches(2, cfg, device)
    tok = torch.zeros(2, 1, dtype=torch.int32, device=device)
    return BuiltPipeline(fn=srv.decode_fn(8), args=(tok, caches),
                         key_arg=None)


def _cap2(cfg) -> int:
    cap_m, cap_n = cfg.geom.capacity
    return cap_m * cap_n


def registered_pipelines(*, device="cuda",
                         scale: str = "paper") -> List[PipelineSpec]:
    """The registry in the reference's (manifest) order, built on
    ``device`` at ``scale`` (``"paper"`` or ``"cpu"``)."""
    if scale not in SCALES:
        raise ValueError(f"unknown scale {scale!r}; expected one of {SCALES}")
    small = _cap2(_small_cfg())        # 64 x 64 capacity blocks
    vcfg, vn, vcap = _virtual(scale)
    virt = _cap2(vcfg)                 # one capacity block of the operator
    vblocks = (vn // vcap) ** 2        # its grid: 1,024 at paper scale
    d = torch.device(device)
    specs: List[PipelineSpec] = []

    def add(name, placement, direction, backend, build, **kw):
        specs.append(PipelineSpec(name=name, placement=placement,
                                  direction=direction, backend=backend,
                                  build=build, device=d, **kw))

    def solve(name, placement, build, maxiter, **kw):
        """A reference-backend solve; ``build`` runs the ``maxiter`` that
        the record states."""
        add(name, placement, "solve", "reference",
            functools.partial(build, maxiter=maxiter), maxiter=maxiter,
            max_launches=0, allow_baked=True, **kw)

    # The cuda backend launches one EC kernel + one stencil a local MVM or
    # group call, one EC kernel a block + one stencil a streamed MVM, one
    # EC kernel a block of every member of a chain (tier-2 plain there).
    for backend in ("reference", "cuda"):
        cuda = backend == "cuda"
        for transpose, direction in ((False, "forward"), (True, "rmatvec")):
            add(f"local-{direction}-{backend}", "local", direction, backend,
                functools.partial(_build_local, d, backend, transpose),
                aval_budget=64 * small, max_launches=2 if cuda else 0)
            add(f"streamed-{direction}-{backend}", "streamed", direction,
                backend,
                functools.partial(_build_streamed, d, backend, transpose),
                aval_budget=64 * small, max_launches=17 if cuda else 0,
                producer_per_mvm=16, allow_baked=True)

    group_budget = 8 * 64 * small       # an 8-member group of small images
    for backend in ("reference", "cuda"):
        cuda = backend == "cuda"
        for transpose, direction in ((False, "forward"), (True, "rmatvec")):
            add(f"group-{direction}-{backend}", "local", direction, backend,
                functools.partial(_build_group, d, backend, transpose),
                aval_budget=group_budget, max_launches=2 if cuda else 0,
                allow_baked=True)
        add(f"group-chain-wholemodel-{backend}", "local", "forward", backend,
            functools.partial(_build_chain, d, backend),
            aval_budget=group_budget, max_launches=32 if cuda else 0,
            allow_baked=True)
    add("group-moe-experts-reference", "local", "forward", "reference",
        functools.partial(_build_group_moe, d), aval_budget=group_budget,
        max_launches=0, allow_baked=True)

    add("local-aged-forward-reference", "local", "forward", "reference",
        functools.partial(_build_local_aged, d), aval_budget=64 * small,
        max_launches=0, allow_baked=True)

    for transpose, direction in ((False, "forward"), (True, "rmatvec")):
        add(f"distributed-{direction}-reference", "distributed", direction,
            "reference",
            functools.partial(_build_distributed_dense, d, transpose, (1, 1)),
            aval_budget=64 * small, max_launches=0,
            per_device_budget=64 * small)

    for mesh_shape, min_dev in (((1, 1), 1), ((2, 4), 8)):
        tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
        for transpose, direction in ((False, "forward"), (True, "rmatvec")):
            add(f"distributed-virtual65536-{direction}-{tag}", "distributed",
                direction, "reference",
                functools.partial(_build_virtual, d, scale, transpose,
                                  mesh_shape),
                min_devices=min_dev,
                aval_budget=16 * virt,               # << n^2 = 1024 * virt
                max_launches=0, producer_per_mvm=vblocks,
                per_device_budget=16 * virt, allow_baked=True)

    solve("solve-cg-streamed-reference", "streamed",
          functools.partial(_build_cg, d), 50, aval_budget=64 * small,
          producer_per_mvm=16)
    add("serving-decode-fused-rwkv6", "local", "decode", "reference",
        functools.partial(_build_serving_decode, d), aval_budget=1 << 20,
        allow_baked=True)
    solve("solve-pdhg-distributed-virtual65536-1x1", "distributed",
          functools.partial(_build_pdhg, d, scale, (1, 1)), ANALYSIS_MAXITER,
          aval_budget=16 * virt, producer_per_mvm=vblocks,
          per_device_budget=16 * virt)
    solve("solve-lsqr-streamed-reference", "streamed",
          functools.partial(_build_lsqr, d), 50, aval_budget=64 * small,
          producer_per_mvm=16)
    solve("solve-lanczos-streamed-reference", "streamed",
          functools.partial(_build_lanczos, d), 24, aval_budget=64 * small,
          producer_per_mvm=16)
    solve("solve-admm-streamed-reference", "streamed",
          functools.partial(_build_admm, d), 100, aval_budget=64 * small,
          producer_per_mvm=16)
    solve("solve-lstsq-distributed-virtual65536-2x4", "distributed",
          functools.partial(_build_lstsq_virtual, d, scale, (2, 4)),
          ANALYSIS_MAXITER, min_devices=8, aval_budget=16 * virt,
          producer_per_mvm=vblocks, per_device_budget=16 * virt)
    return specs


def verify_pipeline(spec: PipelineSpec, *,
                    peak: bool = False) -> Dict[str, V.Report]:
    """Build one registered pipeline, run it once under all five passes
    (``peak``: under the allocator's peak too, a CUDA run only)."""
    built = spec.build()
    return V.run_all(
        built.fn, *built.args,
        aval_budget=spec.aval_budget or None,
        max_launches=spec.max_launches,
        producer=built.producer,
        producer_per_mvm=spec.producer_per_mvm,
        mvms=built.mvms,
        allowed_axes=built.allowed_axes or None,
        per_device_budget=spec.per_device_budget,
        allow_baked=spec.allow_baked,
        key_arg=built.key_arg,
        peak=peak)


def manifest_record(spec: PipelineSpec,
                    reports: Dict[str, V.Report]) -> Dict[str, Any]:
    """The JSON-able row ``INVARIANTS_torch.json`` stores for one pipeline:
    the reference's fields that a run reproduces, and the port's own
    (``launches`` on the card only: the plain twins on the CPU launch
    nothing)."""
    ab = reports["AvalBound"].summary
    dc = reports["DispatchCount"].summary
    kr = reports["KeyReuse"].summary
    ca = reports["CollectiveAudit"].summary
    row = {
        "name": spec.name,
        "placement": spec.placement,
        "direction": spec.direction,
        "backend": spec.backend,
        "min_devices": spec.min_devices,
        "max_elements": ab["max_elements"],
        "aval_budget": spec.aval_budget,
        "producer_calls": dc["producer_calls"],
        "key_consumptions": kr["consumptions"],
        "distinct_keys": kr["distinct_keys"],
        "key_repeats": kr["repeats"],
        "psums": ca["psums"],
        "gathers": ca["gathers"],
        "mvms": dc["mvms"],
        "maxiter": spec.maxiter,
        "violations": sorted(
            str(v) for r in reports.values() for v in r.violations),
    }
    if spec.device.type == "cuda":
        row["launches"] = dc["launches"]
    return row


@dataclasses.dataclass
class Checked:
    """One entry of :func:`check_section`."""

    name: str
    #: the run's record (None: a manifest entry the registry lacks)
    row: Optional[Dict[str, Any]]
    reports: Dict[str, V.Report]
    #: field -> (measured, manifest) wherever the two differ
    diff: Dict[str, Tuple[Any, Any]]
    seconds: float = 0.0


def check_section(device, manifest: Dict[str, Any], *,
                  peak: bool = False) -> Iterator[Checked]:
    """Run every registered pipeline on ``device`` at its type's scale
    (:data:`SCALE_OF`) under the five audits, and yield each one's record
    with the fields in which it differs from ``manifest``'s section for
    the device's type, entry by entry as they finish; then one
    :class:`Checked` with no row for each manifest entry the registry
    lacks.  ``peak``: each virtual entry also under
    :func:`~repro_torch.analysis.memory.peak_bytes` (a CUDA run only)."""
    device = torch.device(device)
    section = manifest.get(device.type, {})
    names = set()
    for spec in registered_pipelines(device=device,
                                     scale=SCALE_OF[device.type]):
        names.add(spec.name)
        t0 = time.perf_counter()
        reports = verify_pipeline(spec, peak=peak and spec.virtual)
        seconds = time.perf_counter() - t0
        row = manifest_record(spec, reports)
        want = section.get(spec.name, {})
        diff = {k: (row.get(k), want.get(k))
                for k in sorted(set(row) | set(want))
                if row.get(k) != want.get(k)}
        yield Checked(spec.name, row, reports, diff, seconds)
    for name in sorted(set(section) - names):
        yield Checked(name, None, {}, {"name": (None, name)})
