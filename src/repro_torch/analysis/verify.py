"""Invariant audits of the port (of :mod:`repro.analysis.verify`): the five
passes over one run of a call.

The paper's headline claims are structural properties of the program:

* a >= 65,536^2 solve never holds an A-sized tensor (**AvalBound**);
* an MVM launches a bounded number of kernels and calls the block producer
  at most once a block (**DispatchCount**);
* no key is drawn from at two places, and every draw is derived from the
  call's key, so the block-key schedule is collision-free and draw identity
  across placements holds (**KeyReuse**);
* no float64 leaks, no sub-f32 accumulators and no sub-f32 psum operands
  (**PrecisionLint**);
* the only reductions across ranks are psums over the declared mesh axes,
  and no join moves more than its declared budget (**CollectiveAudit**).

The reference proves them on a jaxpr before anything runs.  Eager PyTorch
has no trace, so each pass here **runs the call once and audits that run**:
a :class:`~torch.utils._python_dispatch.TorchDispatchMode` sees every
operator (the largest tensor, through :mod:`.memory`'s census, float64
tensors, in-place writes of float16 / bfloat16 tensors), the hooks of
:func:`repro_torch.core.prng.generator` and of
:func:`repro_torch.launch.mesh.psum` / ``gather_to_lead`` hand every draw
and every collective to an observer here, which names its caller's line
(:func:`_user_site`, the audits' one frame walker), ``kernels.LAUNCHES``
counts the hand-written kernels' launches and a :class:`CallCounter` the
producer's calls.  :func:`run_all` makes one run under every recorder (and
a second, key-folded run where the baked-key check needs it).  A ``ctypes``
kernel is not an operator: the mode sees its launcher's outputs, not its
reads.

The reference's IR walker (``walk_frames``, ``iter_equations``,
``eqn_subjaxprs``, ``trace``) and ``jaxpr_max_elements`` have no
counterpart: there is no IR to walk, and :func:`aval_bound`'s report (its
``max_elements`` is :func:`~repro_torch.analysis.memory.max_aval_elements`'s
number, with the tensor, operator and line that set it) takes the place of
``jaxpr_max_elements``.

The registry of pipelines these passes run over is
:mod:`repro_torch.analysis.pipelines`; ``tools/check_invariants_torch.py``
holds every registered pipeline to ``INVARIANTS_torch.json``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import prng
from ..launch import mesh as mesh_mod
from .memory import ARGUMENTS, _describe, _LargestTensor, _tensors

__all__ = [
    "Site",
    "Violation",
    "Report",
    "CallCounter",
    "aval_bound",
    "dispatch_count",
    "key_reuse",
    "precision_lint",
    "collective_audit",
    "run_all",
]

_SUB_F32 = (torch.float16, torch.bfloat16)
#: where a site is not: torch, this package and the two hooked modules
_SKIP = (os.path.dirname(torch.__file__), os.path.dirname(__file__),
         prng.__file__, mesh_mod.__file__)


# --------------------------------------------------------------------------
# attribution
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Site:
    """Where a violation lives: the aten operator or hooked function, and
    the first user frame outside ``torch`` and this package.  ``path`` is
    the reference's IR path; a run has none."""

    primitive: str
    path: Tuple[str, ...] = ()
    file: Optional[str] = None
    line: Optional[int] = None
    function: Optional[str] = None

    def __str__(self) -> str:
        loc = "/".join((*self.path, self.primitive)) or self.primitive
        if self.file is not None:
            src = self.file.rsplit("/", 1)[-1]
            loc += f" @ {src}:{self.line}"
            if self.function:
                loc += f" (in {self.function})"
        return loc


def _user_site(primitive: str) -> Site:
    """``primitive`` at the first frame outside ``torch``, this package
    and the hooked ``prng`` and ``mesh`` modules: the one frame walker of
    the audits."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename.startswith(_SKIP):
        f = f.f_back
    if f is None:
        return Site(primitive)
    return Site(primitive, (), f.f_code.co_filename, f.f_lineno,
                f.f_code.co_name)


@dataclasses.dataclass(frozen=True)
class Violation:
    pass_name: str
    message: str
    site: Optional[Site] = None

    def __str__(self) -> str:
        tail = f" [{self.site}]" if self.site is not None else ""
        return f"{self.pass_name}: {self.message}{tail}"


@dataclasses.dataclass
class Report:
    """Result of one pass: summary metrics plus any violations."""

    pass_name: str
    violations: List[Violation] = dataclasses.field(default_factory=list)
    summary: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def assert_ok(self) -> "Report":
        if self.violations:
            lines = "\n  ".join(str(v) for v in self.violations)
            raise AssertionError(f"{self.pass_name} failed:\n  {lines}")
        return self

    def __str__(self) -> str:
        status = "ok" if self.ok else f"{len(self.violations)} violation(s)"
        return f"[{self.pass_name}] {status} {self.summary}"


class CallCounter:
    """Wrap a block producer to count its calls: wrap, run, then hand the
    counter to :func:`dispatch_count`."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.calls = 0

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        self.calls += 1
        return self.fn(*args, **kwargs)


# --------------------------------------------------------------------------
# one audited run
# --------------------------------------------------------------------------

_WRITTEN: Dict[Any, Tuple[str, ...]] = {}


def _written_args(func) -> Tuple[str, ...]:
    """The names of the arguments ``func`` writes (in place or ``out=``)."""
    names = _WRITTEN.get(func)
    if names is None:
        names = tuple(a.name for a in func._schema.arguments
                      if a.alias_info is not None and a.alias_info.is_write)
        _WRITTEN[func] = names
    return names


class _Mode(_LargestTensor):
    """Every operator of the run: :mod:`.memory`'s census of the largest
    tensor (its site the operator and first user line), and float64
    tensors and float16 / bfloat16 tensors written in place more than
    once."""

    def __init__(self):
        super().__init__()
        self.f64: List[Tuple[str, Site]] = []
        self.low_writes: List[Tuple[str, Site]] = []
        self._writes: Dict[int, list] = {}

    def _site(self, op: str) -> Site:
        return Site(op) if op == ARGUMENTS else _user_site(op)

    def observe(self, func, args, kwargs, out) -> None:
        super().observe(func, args, kwargs, out)
        self._lint(func, args, kwargs, out)

    def _lint(self, func, args, kwargs, out) -> None:
        for t in _tensors((args, kwargs, out), []):
            if t.dtype == torch.float64:
                self.f64.append((_describe(t), _user_site(str(func))))
        names = _written_args(func)
        if not names:
            return
        schema = func._schema.arguments
        for i, a in enumerate(schema):
            if a.name not in names:
                continue
            t = args[i] if i < len(args) else kwargs.get(a.name)
            if not isinstance(t, torch.Tensor) or t.dtype not in _SUB_F32:
                continue
            base = t._base if t._base is not None else t
            seen = self._writes.get(id(base))
            if seen is None or seen[0]() is not base:
                self._writes[id(base)] = [weakref.ref(base), 1]
                continue
            seen[1] += 1
            if seen[1] == 2:
                self.low_writes.append((_describe(base),
                                        _user_site(str(func))))


@dataclasses.dataclass
class _Run:
    """What one audited run saw."""

    out: Any = None
    mode: Optional[_Mode] = None
    draws: List[Tuple[int, Site]] = dataclasses.field(default_factory=list)
    psums: List[Tuple[Tuple[str, ...], List[str], Site]] = \
        dataclasses.field(default_factory=list)
    gathers: List[Tuple[int, Site]] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    producer_calls: Optional[int] = None
    mvms: Optional[int] = None
    peak_bytes: Optional[int] = None


def _observe(fn: Callable, args, kwargs, *, mode: bool = True,
             producer: Optional[CallCounter] = None,
             mvms: Optional[Callable[[], int]] = None,
             peak: bool = False) -> _Run:
    """Run ``fn(*args, **kwargs)`` once under the recorders; the hooks are
    removed again however the call ends."""
    from .. import kernels
    from .memory import peak_bytes
    run = _Run(mode=_Mode() if mode else None)

    def on_draw(key):
        run.draws.append((key, _user_site("generator")))

    def on_collective(kind, axes, tensors, mesh):
        # The reference's audit counts psum equations: jax.lax.pmean is a
        # psum and a division, pmax and ppermute are neither reduction nor
        # gather there.
        if kind in ("psum", "pmean"):
            run.psums.append((axes, [str(t.dtype) for t in tensors],
                              _user_site(kind)))
        elif kind == "gather":
            run.gathers.append((sum(t.numel() for t in tensors),
                                _user_site("gather_to_lead")))

    launches0 = dict(kernels.LAUNCHES)
    calls0 = producer.calls if producer is not None else 0
    mvms0 = mvms() if mvms is not None else 0
    prng.OBSERVERS.append(on_draw)
    mesh_mod.OBSERVERS.append(on_collective)
    box = []

    def call(*a, **k):
        if run.mode is None:
            box.append(fn(*a, **k))
            return
        with run.mode:
            box.append(fn(*a, **k))

    try:
        if peak:
            run.peak_bytes = peak_bytes(call, *args, **kwargs)
        else:
            call(*args, **kwargs)
    finally:
        prng.OBSERVERS.remove(on_draw)
        mesh_mod.OBSERVERS.remove(on_collective)
    run.out = box[0]
    if run.mode is not None:
        run.mode.finish(args, kwargs, run.out)
    run.launches = {k: v - launches0.get(k, 0)
                    for k, v in kernels.LAUNCHES.items()
                    if v != launches0.get(k, 0)}
    if producer is not None:
        run.producer_calls = producer.calls - calls0
    if mvms is not None:
        run.mvms = mvms() - mvms0
    return run


# --------------------------------------------------------------------------
# the five passes, each on a run
# --------------------------------------------------------------------------

def _aval_report(run: _Run, budget: Optional[int]) -> Report:
    m = run.mode
    report = Report("AvalBound", summary={
        "max_elements": m.elements,
        "max_aval": m.largest,
        "at": str(m.site) if m.site is not None else "<toplevel>",
        "budget": budget,
    })
    if run.peak_bytes is not None:
        report.summary["peak_bytes"] = run.peak_bytes
    if budget is not None and m.elements > budget:
        report.violations.append(Violation(
            "AvalBound",
            f"largest tensor {m.largest} has {m.elements} elements > "
            f"budget {budget}", m.site))
    return report


def _dispatch_report(run: _Run, max_launches: Optional[int],
                     producer_per_mvm: Optional[int]) -> Report:
    total = sum(run.launches.values())
    report = Report("DispatchCount", summary={
        "launches": dict(sorted(run.launches.items())),
        "total_launches": total,
        "producer_calls": run.producer_calls,
        "mvms": run.mvms,
    })
    if max_launches is not None and total > max_launches:
        report.violations.append(Violation(
            "DispatchCount",
            f"{total} kernel launches {report.summary['launches']} > budget "
            f"{max_launches}"))
    if producer_per_mvm is not None and run.producer_calls is not None:
        budget = producer_per_mvm * (1 if run.mvms is None else run.mvms)
        if run.producer_calls > budget:
            report.violations.append(Violation(
                "DispatchCount",
                f"producer invoked {run.producer_calls}x > budget {budget} "
                f"({producer_per_mvm} blocks x {run.mvms} MVMs: a block "
                f"produced more than once an MVM)"))
    return report


def _key_report(run: _Run, allow_baked: bool,
                again: Optional[set]) -> Report:
    """``again``: the keys the key-folded run drew (None: not checked)."""
    sites: Dict[int, List[Site]] = {}
    for key, site in run.draws:
        at = sites.setdefault(key, [])
        if site not in at:
            at.append(site)
    pairs = sum(len(v) for v in sites.values())
    baked: Dict[Site, int] = {}
    for key, at in sites.items():
        if again is not None and key in again:
            for site in at:
                baked[site] = baked.get(site, 0) + 1
    report = Report("KeyReuse", summary={
        "consumptions": len(run.draws),
        "distinct_keys": len(sites),
        "repeats": len(run.draws) - pairs,
        "baked": None if again is None else sum(baked.values()),
    })
    for key, at in sorted(sites.items()):
        if len(at) > 1:
            where = ", ".join(str(s) for s in at)
            report.violations.append(Violation(
                "KeyReuse",
                f"one key consumed at {len(at)} distinct sites "
                f"(sites: {where})", at[0]))
    if not allow_baked:
        for site, n in baked.items():
            report.violations.append(Violation(
                "KeyReuse",
                f"randomness not derived from the call's key argument "
                f"({n} keys; baked draws break placement draw-identity)",
                site))
    return report


def _precision_report(run: _Run, allow_f64: bool) -> Report:
    report = Report("PrecisionLint", summary={})
    m = run.mode
    n_f64 = 0 if allow_f64 else len(m.f64)
    if not allow_f64:
        for desc, site in m.f64:
            report.violations.append(Violation(
                "PrecisionLint", f"float64 tensor {desc} (silent f64 leak)",
                site))
    for desc, site in m.low_writes:
        report.violations.append(Violation(
            "PrecisionLint",
            f"{desc.split('[')[0]} tensor {desc} written in place more than "
            f"once (sub-f32 accumulator)", site))
    n_low_psum = 0
    for _, dtypes, site in run.psums:
        for name in dtypes:
            if name in ("torch.float16", "torch.bfloat16"):
                n_low_psum += 1
                report.violations.append(Violation(
                    "PrecisionLint",
                    f"{name.replace('torch.', '')} psum operand", site))
    report.summary.update(f64_tensors=n_f64,
                          sub_f32_accumulators=len(m.low_writes),
                          sub_f32_psum_operands=n_low_psum)
    # de-duplicate repeated flags of one tensor at one line
    seen: set = set()
    unique: List[Violation] = []
    for v in report.violations:
        k = (v.message, str(v.site))
        if k not in seen:
            seen.add(k)
            unique.append(v)
    report.violations = unique
    return report


def _collective_report(run: _Run, allowed_axes: Optional[Sequence[str]],
                       per_device_budget: Optional[int]) -> Report:
    allowed = None if allowed_axes is None else frozenset(allowed_axes)
    report = Report("CollectiveAudit", summary={})
    for axes, _, site in run.psums:
        if allowed is not None and not set(axes) <= allowed:
            extra = sorted(set(axes) - allowed)
            report.violations.append(Violation(
                "CollectiveAudit",
                f"psum over undeclared axes {extra} "
                f"(allowed: {sorted(allowed)})", site))
    for moved, site in run.gathers:
        if per_device_budget is None:
            report.violations.append(Violation(
                "CollectiveAudit",
                "gather_to_lead with no declared budget", site))
        elif moved > per_device_budget:
            report.violations.append(Violation(
                "CollectiveAudit",
                f"gather_to_lead moves {moved} elements > per-device budget "
                f"{per_device_budget}", site))
    report.summary.update(
        psums=len(run.psums), gathers=len(run.gathers),
        axes=sorted({a for axes, _, _ in run.psums for a in axes}),
        allowed_axes=sorted(allowed) if allowed else None)
    return report


def _baked_keys(fn, args, kwargs, key_arg: Optional[int], allow_baked: bool,
                run: _Run) -> Optional[set]:
    """The keys a second run with the key argument folded (``fold_in(key,
    1)``) draws from: a key in both runs was not derived from the call's
    key.  None where ``allow_baked`` waives the check.  A call without a
    key argument derives nothing from one: each of its keys is baked."""
    if allow_baked:
        return None
    if key_arg is None:
        return {key for key, _ in run.draws}
    folded = list(args)
    folded[key_arg] = prng.fold_in(folded[key_arg], 1)
    return {key for key, _ in _observe(fn, folded, kwargs, mode=False).draws}


# --------------------------------------------------------------------------
# public passes: each runs the call once
# --------------------------------------------------------------------------

def aval_bound(fn: Callable, *args: Any, budget: Optional[int] = None,
               **kw: Any) -> Report:
    """Largest tensor of one run of ``fn(*args, **kw)`` against an element
    budget; the summary names the tensor, its operator and its line."""
    return _aval_report(_observe(fn, args, kw), budget)


def dispatch_count(fn: Callable, *args: Any,
                   max_launches: Optional[int] = None,
                   producer: Optional[CallCounter] = None,
                   producer_per_mvm: Optional[int] = None,
                   mvms: Optional[Callable[[], int]] = None,
                   **kw: Any) -> Report:
    """Kernel launches and producer calls of one run.

    ``launches`` is the change of ``kernels.LAUNCHES`` over the call, per
    kernel (the plain twins on the CPU count none).  ``producer`` is a
    :class:`CallCounter` around the block producer; ``mvms`` a zero-argument
    callable that reads how many MVMs the handle has executed (its
    difference over the call is the run's MVMs).  Budgets: at most
    ``max_launches`` launches, and at most ``producer_per_mvm`` (the blocks
    of the grid) producer calls an MVM -- no block produced twice in one
    MVM."""
    run = _observe(fn, args, kw, mode=False, producer=producer, mvms=mvms)
    return _dispatch_report(run, max_launches, producer_per_mvm)


def key_reuse(fn: Callable, *args: Any, allow_baked: bool = False,
              key_arg: Optional[int] = -1, **kw: Any) -> Report:
    """Every draw of one run, as (key, site).

    A key drawn from at two distinct sites is a violation; the same key at
    the same site again is counted as ``repeats`` (the eager form of a loop
    body the reference traces once).  Unless ``allow_baked``, the call runs
    a second time with ``args[key_arg]`` folded (``fold_in(key, 1)``): a
    key drawn from in both runs was not derived from the call's key
    (baked).  ``allow_baked=True`` waives that for procedurally generated
    matrix content; the reuse check still applies to it."""
    run = _observe(fn, args, kw, mode=False)
    return _key_report(run, allow_baked,
                       _baked_keys(fn, args, kw, key_arg, allow_baked, run))


def precision_lint(fn: Callable, *args: Any, allow_f64: bool = False,
                   **kw: Any) -> Report:
    """No float64 tensor (unless ``allow_f64``), no float16 / bfloat16
    tensor written in place more than once in the run (an accumulator
    whose rounding compounds), no sub-f32 psum operand."""
    return _precision_report(_observe(fn, args, kw), allow_f64)


def collective_audit(fn: Callable, *args: Any,
                     allowed_axes: Optional[Sequence[str]] = None,
                     per_device_budget: Optional[int] = None,
                     **kw: Any) -> Report:
    """psums only over ``allowed_axes``; every join (``gather_to_lead``)
    within ``per_device_budget`` elements, and declared."""
    run = _observe(fn, args, kw, mode=False)
    return _collective_report(run, allowed_axes, per_device_budget)


def run_all(fn: Callable, *args: Any,
            aval_budget: Optional[int] = None,
            max_launches: Optional[int] = None,
            producer: Optional[CallCounter] = None,
            producer_per_mvm: Optional[int] = None,
            mvms: Optional[Callable[[], int]] = None,
            allowed_axes: Optional[Sequence[str]] = None,
            per_device_budget: Optional[int] = None,
            allow_f64: bool = False,
            allow_baked: bool = False,
            key_arg: Optional[int] = -1,
            peak: bool = False,
            **kw: Any) -> Dict[str, Report]:
    """All five passes over ONE run under every recorder (plus the
    key-folded run unless ``allow_baked``), keyed by pass name.  ``peak``
    runs the call under :func:`~repro_torch.analysis.memory.peak_bytes`
    (a CUDA call only) and adds ``peak_bytes`` to AvalBound's summary."""
    run = _observe(fn, args, kw, producer=producer, mvms=mvms, peak=peak)
    again = _baked_keys(fn, args, kw, key_arg, allow_baked, run)
    return {
        "AvalBound": _aval_report(run, aval_budget),
        "DispatchCount": _dispatch_report(run, max_launches,
                                          producer_per_mvm),
        "KeyReuse": _key_report(run, allow_baked, again),
        "PrecisionLint": _precision_report(run, allow_f64),
        "CollectiveAudit": _collective_report(run, allowed_axes,
                                              per_device_budget),
    }
