"""Deterministic fault injection for the partitioned-service runtime.

Twin of ``repro.core.fault``, pure Python. The paper's simulation (§5.3)
never fails; a serving system must survive losing shards, blowing
maintenance deadlines and dying mid-write, and a fault that cannot be
replayed cannot be regression-tested. So every fault here is keyed by
(slice index, site) and fires exactly as scheduled:

* :class:`FaultInjector` / :class:`StragglerMitigator` — the training
  loop's step-keyed crash and re-dispatch primitives.
* :class:`FaultPlan` — a slice-indexed schedule of service faults:
  **crashes** (:class:`SimulatedCrash` raised at a named site inside the
  cycle, e.g. between validate and commit of ``apply_dynamism``, which the
  recovery driver in :mod:`repro_torch.core.recovery` survives through
  snapshot and journal), **maintenance timeouts** (the first *n* attempts
  of a slice's DiDiC maintenance raise :class:`MaintenanceTimeout`; the
  service retries under a :class:`RetryPolicy`) and **shard failures**
  (a mesh shard down for a range of slices: a service built with a mesh
  serves its sharded replays degraded, through the batched engine, bit-equal
  and counted; a meshless service computes nothing differently, as in the
  JAX package).
* :class:`RetryPolicy` — bounded exponential backoff under a deadline;
  exceeding either raises :class:`RecoveryDeadlineExceeded`.

Crashes and timeouts fire once per scheduled event, so a recovered re-run
of a slice does not crash again; shard failures are a pure predicate of
the slice index. A crashed-and-recovered dynamic run is therefore
bit-exact against the uninterrupted one on all four traffic counters.

**Fault-site registry.** :data:`FAULT_SITES` names every site the port
fires, text for text the JAX package's registry; ``fire``, ``crash`` and
the schedule builders raise ``ValueError`` on any other, so a typo cannot
silently never fire.

====================== ====================================================
``apply:pre_validate`` after the journal intent is written, before any
                       validation ran (entry pending → rolled back)
``apply:pre_commit``   after validation, before any state mutates (entry
                       pending → rolled back; service state unchanged)
``apply:compact``      a structural log is about to overflow the
                       delta-overlay store — fired before the compaction
                       (entry pending → rolled back; the snapshot carries
                       the store geometry, so the re-run compacts
                       identically)
``apply:post_commit``  after every mutation and the journal commit mark
                       (entry committed → re-applied from the journal)
``maintain``           start of a maintenance attempt (timeouts fire here;
                       crashes are honoured too)
``replay``             start of an evaluation-log replay
``serve:admit``        online admission loop, top of a tick, before any
                       server state mutates
``serve:commit``       online admission loop, after the batch replay and
                       before the served counters fold into the server
====================== ====================================================
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Set

__all__ = [
    "FAULT_SITES",
    "SimulatedFault",
    "SimulatedCrash",
    "ShardFailure",
    "MaintenanceTimeout",
    "RecoveryDeadlineExceeded",
    "FaultInjector",
    "StragglerMitigator",
    "FaultEvent",
    "FaultPlan",
    "RetryPolicy",
]


#: Every legal injection site: the site strings the service and the online
#: server pass to :meth:`FaultPlan.fire`, each with where in the cycle it
#: sits and what recovery must guarantee there.
FAULT_SITES: Dict[str, str] = {
    "apply:pre_validate": (
        "apply_dynamism, after the journal intent is written and before "
        "validation — entry stays pending, recovery rolls it back"
    ),
    "apply:pre_commit": (
        "apply_dynamism, after validation and before any state mutates — "
        "entry pending, rolled back; service state unchanged"
    ),
    "apply:compact": (
        "apply_dynamism, when a structural log is about to overflow the "
        "delta-overlay store — before the amortized compaction rebuild; "
        "entry pending, rolled back, and the restored run re-compacts "
        "identically because the snapshot carries the store geometry"
    ),
    "apply:post_commit": (
        "apply_dynamism, after every mutation and the journal commit mark "
        "— entry committed, recovery re-applies it from the journal"
    ),
    "maintain": (
        "start of a maintenance attempt — timeout events fire here before "
        "the deterministic DiDiC pass, so a retry is bit-identical"
    ),
    "replay": "start of an evaluation-log replay",
    "serve:admit": (
        "online admission loop, top of a tick — before arrivals are "
        "pulled or any server state mutates, so a supervised retry of "
        "the tick is bit-identical"
    ),
    "serve:commit": (
        "online admission loop, after the batch replay and before served "
        "counters fold into the server aggregates — the replay is pure, "
        "so a retried tick re-serves the identical batch and folds once"
    ),
}


def _check_site(site: str) -> str:
    if site not in FAULT_SITES:
        raise ValueError(
            f"unknown fault site {site!r}; registered sites: "
            f"{sorted(FAULT_SITES)} (see core.fault.FAULT_SITES)"
        )
    return site


class SimulatedFault(RuntimeError):
    """Base class for every injected fault."""


class SimulatedCrash(SimulatedFault):
    """The process 'dies' at an injection site.

    Nothing in the service catches this: it unwinds to the recovery
    driver, which stands in for a supervisor restarting the process and
    restoring from snapshot and journal.
    """


class ShardFailure(SimulatedFault):
    """A mesh shard is unavailable (raised on direct access attempts)."""


class MaintenanceTimeout(SimulatedFault):
    """One maintenance attempt blew its deadline; retryable."""


class RecoveryDeadlineExceeded(RuntimeError):
    """Retries exhausted their budget (count or wall-clock deadline)."""


@dataclasses.dataclass
class FaultInjector:
    """Step-keyed crash injection for the training loop."""

    fail_at_steps: Sequence[int] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFault(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerMitigator:
    """Deadline-based re-dispatch: EWMA step durations; a step exceeding
    ``deadline_factor × ewma`` counts as a straggler and is re-dispatched
    once (steps must be pure functions of their inputs)."""

    deadline_factor: float = 3.0
    ewma_alpha: float = 0.2
    min_samples: int = 5
    _ewma: float = 0.0
    _n: int = 0
    stragglers_detected: int = 0
    redispatches: int = 0

    def observe(self, duration: float) -> bool:
        """Record a step duration; returns True if it was a straggler."""
        self._n += 1
        if self._n <= self.min_samples:
            self._ewma = duration if self._n == 1 else (
                self.ewma_alpha * duration + (1 - self.ewma_alpha) * self._ewma
            )
            return False
        is_straggler = duration > self.deadline_factor * self._ewma
        if is_straggler:
            self.stragglers_detected += 1
        else:
            self._ewma = self.ewma_alpha * duration + (1 - self.ewma_alpha) * self._ewma
        return is_straggler

    def run_with_mitigation(self, fn: Callable, *args, **kwargs):
        """Run a pure step; re-dispatch once if it blows the deadline."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.observe(time.perf_counter() - t0):
            self.redispatches += 1
            out = fn(*args, **kwargs)  # idempotent pure step
        return out


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``kind`` ∈ {crash, shard, timeout}."""

    kind: str
    slice_index: int
    site: str = ""       # crash: the injection site it fires at
    shard: int = 0       # shard: which shard fails
    duration: int = 1    # shard: failed for this many slices
    times: int = 1       # timeout: consecutive attempts that fail


class FaultPlan:
    """A deterministic, slice-indexed fault schedule.

    The driver calls :meth:`begin_slice` at the top of each slice (the
    online server at the top of each tick); the service fires named sites
    (:meth:`fire`). Crashes and timeouts fire once per event, so a
    recovered re-run of the same slice does not crash again; shard
    failures are a pure predicate of the slice index (:meth:`failed_shards`).
    """

    BASELINE = -1  # begin_slice value for pre-schedule measurements

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: List[FaultEvent] = list(events)
        self._slice: int = self.BASELINE
        self._crashes_fired: Set[int] = set()
        self._timeouts_fired: Dict[int, int] = {}

    # -- schedule builders (chainable) --------------------------------------
    def crash(self, at_slice: int, site: str = "apply:pre_commit") -> "FaultPlan":
        self.events.append(FaultEvent("crash", int(at_slice), site=_check_site(site)))
        return self

    def fail_shard(self, at_slice: int, shard: int, slices: int = 1) -> "FaultPlan":
        self.events.append(FaultEvent(
            "shard", int(at_slice), shard=int(shard), duration=int(slices)
        ))
        return self

    def timeout_maintenance(self, at_slice: int, times: int = 1) -> "FaultPlan":
        self.events.append(FaultEvent("timeout", int(at_slice), site="maintain",
                                      times=int(times)))
        return self

    # -- runtime interface ---------------------------------------------------
    @property
    def current_slice(self) -> int:
        return self._slice

    def begin_slice(self, index: int) -> None:
        self._slice = int(index)

    def failed_shards(self, slice_index: Optional[int] = None) -> FrozenSet[int]:
        """Shards down during ``slice_index`` (default: the current one)."""
        s = self._slice if slice_index is None else int(slice_index)
        return frozenset(
            ev.shard for ev in self.events
            if ev.kind == "shard" and ev.slice_index <= s < ev.slice_index + ev.duration
        )

    def fire(self, site: str) -> None:
        """Raise whatever the plan schedules for (current slice, site)."""
        s = self._slice
        _check_site(site)
        for i, ev in enumerate(self.events):
            if ev.slice_index != s:
                continue
            if ev.kind == "crash" and ev.site == site and i not in self._crashes_fired:
                self._crashes_fired.add(i)
                raise SimulatedCrash(
                    f"injected crash at slice {s} site {site!r}"
                )
            if ev.kind == "timeout" and site == "maintain":
                fired = self._timeouts_fired.get(i, 0)
                if fired < ev.times:
                    self._timeouts_fired[i] = fired + 1
                    raise MaintenanceTimeout(
                        f"injected maintenance timeout at slice {s} "
                        f"(attempt {fired + 1}/{ev.times})"
                    )

    def describe(self) -> List[str]:
        return [str(ev) for ev in self.events]


@dataclasses.dataclass
class RetryPolicy:
    """Bounded exponential backoff under a wall-clock deadline.

    :meth:`wait` is called after the ``attempt``-th failure (1-based) with
    the elapsed time since the first attempt; it sleeps the backoff or
    raises :class:`RecoveryDeadlineExceeded` once either budget is spent.
    ``sleep`` is injectable so tests run with a virtual clock.
    """

    max_retries: int = 8
    backoff_base_s: float = 0.005
    backoff_factor: float = 2.0
    deadline_s: float = 5.0
    sleep: Callable[[float], None] = time.sleep

    def wait(self, attempt: int, elapsed_s: float) -> None:
        if attempt > self.max_retries or elapsed_s >= self.deadline_s:
            raise RecoveryDeadlineExceeded(
                f"maintenance retry budget exhausted after {attempt - 1} "
                f"retries / {elapsed_s:.3f}s (max_retries={self.max_retries}, "
                f"deadline={self.deadline_s}s)"
            )
        delay = self.backoff_base_s * self.backoff_factor ** (attempt - 1)
        self.sleep(min(delay, max(self.deadline_s - elapsed_s, 0.0)))
