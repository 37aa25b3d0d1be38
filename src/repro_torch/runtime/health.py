"""Fault injection, the health ledger, and graceful kernel degradation.

The port's copy of ``repro/runtime/health.py``, as far as the serving
path uses it.  Every place the path can plausibly fail calls
``maybe_inject(site)``; ``REPRO_FAULT_PLAN`` arms faults::

    REPRO_FAULT_PLAN="<site>:<step>:<kind>[,<site>:<step>:<kind>...]"

``step`` is the 0-based hit count of that site (``*`` = every hit) and
``kind`` is ``raise`` (raise ``SimulatedFailure``), ``nan`` (the caller
poisons its output with NaNs), ``hang-timeout`` (sleep
``REPRO_FAULT_HANG_S`` seconds, default 0.25, then continue) or ``kill``
(``SIGKILL`` the process at the site: no ``finally``, no flush, no
``atexit`` — the crash that the request journal and snapshots must
survive).  PyTorch runs eagerly, so every site fires on every call — a
``kernel.*`` or ``layers.*`` site counts one hit per launch, not one per
traced shape as in the JAX package.  Modules that own a site register it
at import time (``register_site``).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Dict, List, Optional, Tuple


class SimulatedFailure(RuntimeError):
    """Raised by an armed ``raise``-kind injection site."""


FAULT_KINDS = ("raise", "nan", "hang-timeout", "kill")

# The drillable sites; a module that owns another registers it when it is
# imported (the journal, snapshot, restore and checkpoint sites).
INJECTION_SITES: List[str] = [
    "serve.prefill",
    "serve.decode_step",
    "autotune.load",
    "autotune.save",
    "kernel.matmul",
    "kernel.conv2d",
    "kernel.binary_matmul",
    "kernel.attention",
    "layers.attention",
    "layers.mlp",
    "pool.alloc",
    "pool.spill",
]


def register_site(site: str) -> str:
    """Idempotently add ``site`` to the drillable-site registry."""
    if site not in INJECTION_SITES:
        INJECTION_SITES.append(site)
    return site


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    site: str
    step: Optional[int]      # None = every hit ("*")
    kind: str


@dataclasses.dataclass
class FiredFault:
    site: str
    hit: int
    kind: str
    timestamp: float


def parse_fault_plan(plan: str) -> List[FaultSpec]:
    """Parse ``site:step:kind[,...]``; a malformed entry raises
    ValueError so a typo'd drill fails loudly."""
    specs: List[FaultSpec] = []
    for part in plan.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.rsplit(":", 2)
        if len(fields) != 3:
            raise ValueError(f"fault plan entry {part!r} is not "
                             f"site:step:kind")
        site, step_s, kind = fields
        if kind == "hang":
            kind = "hang-timeout"
        if kind not in FAULT_KINDS:
            raise ValueError(f"fault kind {kind!r} not in {FAULT_KINDS}")
        step = None if step_s == "*" else int(step_s)
        specs.append(FaultSpec(site=site, step=step, kind=kind))
    return specs


_site_hits: Dict[str, int] = {}
_fired: List[FiredFault] = []


def reset_faults() -> None:
    """Zero the per-site hit counters and the fired-fault log."""
    _site_hits.clear()
    _fired.clear()


def fault_log() -> List[FiredFault]:
    return list(_fired)


def maybe_inject(site: str) -> Optional[str]:
    """Advance ``site``'s hit counter and fire any armed fault.

    Returns ``"nan"`` or ``"hang-timeout"`` for faults the caller
    realizes (the sleep has already happened), None when nothing fired;
    ``raise``-kind faults raise ``SimulatedFailure`` and ``kill``-kind
    faults never return.
    """
    hit = _site_hits.get(site, 0)
    _site_hits[site] = hit + 1
    plan = os.environ.get("REPRO_FAULT_PLAN")
    for spec in parse_fault_plan(plan) if plan else []:
        if spec.site != site or (spec.step is not None and spec.step != hit):
            continue
        _fired.append(FiredFault(site, hit, spec.kind, time.time()))
        if spec.kind == "raise":
            raise SimulatedFailure(f"injected failure at {site} (hit {hit})")
        if spec.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if spec.kind == "hang-timeout":
            time.sleep(float(os.environ.get("REPRO_FAULT_HANG_S", "0.25")))
        return spec.kind
    return None


# ---------------------------------------------------------------------------
# Health ledger.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StepRecord:
    step: int
    seconds: float
    timestamp: float


@dataclasses.dataclass
class HealthEvent:
    """One ledger row: what happened, where, at which step."""

    kind: str
    site: str = ""
    step: Optional[int] = None
    detail: str = ""
    timestamp: float = dataclasses.field(default_factory=time.time)


class HealthMonitor:
    """Step timing, straggler detection and the serving event ledger.

    A step is a straggler when it takes more than ``threshold`` times the
    median of the last ``window`` steps.  Demotions, retries, re-probes,
    admission rejections and injected faults land in ``events`` via
    ``note``; ``report()`` rolls them up.
    """

    def __init__(self, window: int = 32, threshold: float = 3.0):
        self.window = window
        self.threshold = threshold
        self.records: List[StepRecord] = []
        self.stragglers: List[StepRecord] = []
        self.events: List[HealthEvent] = []

    def record(self, step: int, seconds: float) -> bool:
        rec = StepRecord(step, seconds, time.time())
        recent = [r.seconds for r in self.records[-self.window:]]
        self.records.append(rec)
        if len(recent) >= 8:
            med = sorted(recent)[len(recent) // 2]
            if seconds > self.threshold * med:
                self.stragglers.append(rec)
                self.note("straggler", step=step,
                          detail=f"{seconds:.3f}s vs median {med:.3f}s")
                return True
        return False

    def note(self, kind: str, site: str = "", step: Optional[int] = None,
             detail: str = "") -> HealthEvent:
        ev = HealthEvent(kind=kind, site=site, step=step, detail=detail)
        self.events.append(ev)
        return ev

    def events_of(self, kind: str) -> List[HealthEvent]:
        return [e for e in self.events if e.kind == kind]

    @property
    def median_step_seconds(self) -> float:
        if not self.records:
            return 0.0
        xs = sorted(r.seconds for r in self.records)
        return xs[len(xs) // 2]

    def report(self) -> Dict[str, object]:
        by_kind: Dict[str, int] = {}
        for e in self.events:
            by_kind[e.kind] = by_kind.get(e.kind, 0) + 1
        return {
            "steps": len(self.records),
            "median_step_seconds": self.median_step_seconds,
            "stragglers": len(self.stragglers),
            "events": by_kind,
            "injected_faults": [(f.site, f.hit, f.kind) for f in fault_log()],
        }


# ---------------------------------------------------------------------------
# Graceful kernel degradation.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DegradationPolicy:
    """When a CPU serving engine falls back to the plain PyTorch path
    (on the card the engine retries the kernels and never demotes).

    ``backend_for(step)`` returns ``"primary"`` (the kernel wrappers) or
    ``"degraded"`` (``layers.forced_backend("torch")``).  ``on_failure``
    demotes after a failed step; after ``cooldown_steps`` degraded steps
    the next step re-probes the primary path.  ``max_retries`` and
    ``backoff_base_s`` bound the per-step retry loop.
    """

    max_retries: int = 2
    backoff_base_s: float = 0.02
    cooldown_steps: int = 4

    def __post_init__(self):
        self.demoted = False
        self.demoted_at: Optional[int] = None
        self.demotions: List[Tuple[str, int]] = []
        self.probes = 0

    def backend_for(self, step: int,
                    monitor: Optional[HealthMonitor] = None) -> str:
        if not self.demoted:
            return "primary"
        if step - self.demoted_at >= self.cooldown_steps:
            self.probes += 1
            if monitor is not None:
                monitor.note("probe", step=step,
                             detail="re-probing primary kernel path "
                                    "after cooldown")
            self.demoted = False
            self.demoted_at = None
            return "primary"
        return "degraded"

    def on_failure(self, site: str, step: int, error: BaseException,
                   monitor: Optional[HealthMonitor] = None) -> None:
        self.demoted = True
        self.demoted_at = step
        self.demotions.append((site, step))
        if monitor is not None:
            monitor.note("demotion", site=site, step=step,
                         detail=f"{type(error).__name__}: {error}")

    def backoff_seconds(self, attempt: int) -> float:
        return self.backoff_base_s * (2 ** attempt)
