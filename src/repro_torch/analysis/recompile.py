"""Rebuild sentinel: enforce zero program rebuilds across growth slices.

Twin of ``repro.analysis.recompile``. The JAX sentinel counts XLA
compilations; torch eager compiles nothing, so here a "recompile" is an
object that holds a device program or its capacity buffers being built
again: a :class:`~repro_torch.core.traffic_batched.BatchedTrafficEngine`,
a :class:`~repro_torch.core.traffic_sharded.ShardedTrafficReplayer`, a
capacity mesh program (``core/didic_distributed.py``) or a CUDA kernel's
library. Those sites report each build through
:mod:`repro_torch.builds` as ``(name, geometry)``, geometry being the
store's ``(n_cap, e_cap)`` (the graph's ``(n_nodes, n_edges)`` without a
store; the library's hash for a kernel).

The delta-overlay store (:class:`repro_torch.graphs.structure.GraphStore`)
sizes every growth-facing buffer to its capacity, and a grown graph is
adopted by the objects already built, so a 20×5% vertex-growth schedule
builds everything once during warm-up (the ``begin`` replay plus slice 0,
where ``prepare_growth`` attaches the store and builds the engine, the
replayer and the DiDiC overlay tables) and then runs **steady-state: zero
rebuilds from slice 1 on**. This sentinel drives that schedule through
:class:`~repro_torch.core.dynamic_runtime.DynamicExperimentRuntime` on a
one-rank replay mesh, records every build, and classifies each one after
warm-up as the JAX sentinel does:

* ``shape-change`` — same name, new geometry: the store compacted (a new
  store, fresh caches) and everything was built again at the new
  capacity.
* ``identity-rehash`` — same name rebuilt at the *same* geometry: a cache
  missed (keyed on something other than the store lineage) and a
  bit-identical object was built from scratch.
* ``new-closure`` — a name first built after warm-up (a lazily-built path).

**Refreshes are not rebuilds.** The DiDiC overlay tables
(``_overlay_tables_for``) and a mesh program's halo tables are rewritten
for each grown graph at its extents: their bucket shapes follow the live
degree distribution. The JAX package rebuilds these tables too (keyed on
the extents) without a retrace, and eager torch compiles nothing for
them, so the report counts them per slice as ``refreshes`` and never turns
them into findings.

Findings (rule ``recompile/growth-retrace``, the JAX rule id, so that
``--rule`` filters and baseline keys mean the same in both lints) are
lint failures, never baseline entries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Tuple

from repro_torch import builds
from repro_torch.analysis.framework import Finding


@dataclasses.dataclass
class CompileEvent:
    """One build: ``shapes`` holds its geometry (the JAX name kept, so the
    classifier is the JAX one)."""

    slice_label: str
    name: str
    shapes: str


@dataclasses.dataclass
class Retrace:
    closure: str
    cause: str          # shape-change | identity-rehash | new-closure
    count: int
    slices: List[str]
    detail: str

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


class _BuildCapture:
    """The listener: builds and refreshes, each under the current slice."""

    def __init__(self):
        self.events: List[CompileEvent] = []
        self.refreshes: List[CompileEvent] = []
        self.slice_label = "warmup"

    def __call__(self, kind: str, name: str, geometry: tuple) -> None:
        ev = CompileEvent(self.slice_label, name, str(tuple(geometry)))
        (self.events if kind == "build" else self.refreshes).append(ev)


@contextlib.contextmanager
def capture_builds() -> Iterator[_BuildCapture]:
    """Record every build and refresh the port reports while open."""
    cap = _BuildCapture()
    builds.add_listener(cap)
    try:
        yield cap
    finally:
        builds.remove_listener(cap)


def classify(events: List[CompileEvent],
             warmup_labels: Tuple[str, ...] = ("warmup", "slice0")) -> List[Retrace]:
    """Classify every build after the warm-up slices (see module doc); the
    JAX classifier, its messages worded for builds."""
    history: Dict[str, List[CompileEvent]] = {}
    out: Dict[Tuple[str, str], Retrace] = {}
    for ev in events:
        prior = history.setdefault(ev.name, [])
        if ev.slice_label not in warmup_labels:
            if not prior:
                cause, detail = "new-closure", (
                    f"first built at {ev.slice_label}"
                )
            elif any(p.shapes == ev.shapes for p in prior):
                cause, detail = "identity-rehash", (
                    "rebuilt at an identical geometry — the cache holding it "
                    "missed for the grown graph, so the same object was "
                    "built from scratch"
                )
            else:
                cause, detail = "shape-change", (
                    f"{prior[-1].shapes} -> {ev.shapes}"
                )
            key = (ev.name, cause)
            r = out.get(key)
            if r is None:
                out[key] = Retrace(ev.name, cause, 1, [ev.slice_label], detail)
            else:
                r.count += 1
                if ev.slice_label not in r.slices:
                    r.slices.append(ev.slice_label)
        prior.append(ev)
    return sorted(out.values(), key=lambda r: (-r.count, r.closure, r.cause))


#: build-name prefix -> the module that builds it
_BUILD_PATHS = {
    "engine": "src/repro_torch/core/traffic_batched.py",
    "replayer": "src/repro_torch/core/traffic_sharded.py",
    "mesh_program": "src/repro_torch/core/didic_distributed.py",
}


def _closure_path(name: str) -> str:
    """Source of a built object: its module, or a kernel's CUDA source."""
    prefix, _, rest = name.partition(":")
    if prefix == "kernel":
        return f"src/repro_torch/csrc/{rest}.cu"
    return _BUILD_PATHS.get(prefix, "(unknown build site)")


def run_growth_sentinel(
    slices: int = 20,
    amount: float = 0.05,
    insert_rate: float = 0.5,
    scale: float = 0.002,
    n_ops: int = 48,
    k: int = 4,
    maintain_every: int = 6,
    seed: int = 0,
    root=None,
    device=None,
) -> Dict:
    """Drive a growth schedule and report every post-warm-up rebuild.

    ``device`` is where the service runs, ``None`` meaning CUDA. Without an
    open process group one rank of its own is opened (NCCL on the card,
    gloo on the CPU) and destroyed at the end; an open group is used as it
    is. Returns a JSON-ready report; ``findings_from_report`` turns the
    rebuilds into lint findings.
    """
    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.core import partitioners
    from repro_torch.core.didic import DidicConfig
    from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.traffic import generate_ops
    from repro_torch.graphs import datasets
    from repro_torch.launch.mesh import make_replay_mesh, open_group

    dev = resolve_device(device)
    opened = open_group(dev)
    try:
        graph = datasets.load("filesystem", scale=scale, seed=1)
        svc = PartitionedGraphService(
            graph, k, didic=DidicConfig(k=k, iterations=4),
            mesh=make_replay_mesh(device=dev), maintenance="shared",
        )
        svc.partition_with(partitioners.random_partition(graph.n_nodes, k, seed=0))
        ops = generate_ops(graph, n_ops=n_ops, seed=3)
        rt = DynamicExperimentRuntime(svc, insert_method="fewest_vertices",
                                      seed=seed)

        per_slice: List[Dict] = []
        with capture_builds() as cap:
            cap.slice_label = "warmup"
            t0 = time.perf_counter()
            rt.begin(ops)
            warmup_s = time.perf_counter() - t0
            for i in range(slices):
                cap.slice_label = f"slice{i}"
                n_before, r_before = len(cap.events), len(cap.refreshes)
                t0 = time.perf_counter()
                rt.run_slice(i, ops, amount, maintain_every=maintain_every,
                             insert_rate=insert_rate)
                per_slice.append({
                    "slice": i,
                    "rebuilds": len(cap.events) - n_before,
                    "refreshes": len(cap.refreshes) - r_before,
                    "seconds": round(time.perf_counter() - t0, 3),
                    "n_nodes": int(rt.service.graph.n_nodes),
                })
        store = svc.graph.store
        tensor_devices = sorted({
            str(t.device)
            for key, obj in (store.caches.items() if store is not None else ())
            if key[0] in ("engine", "replayer")
            for t in vars(obj).values() if isinstance(t, torch.Tensor)
        })
    finally:
        if opened:
            dist.destroy_process_group()

    retraces = classify(cap.events)
    steady = per_slice[-1]["rebuilds"] == 0 if per_slice else True
    return {
        "schedule": {
            "slices": slices, "amount": amount, "insert_rate": insert_rate,
            "scale": scale, "n_ops": n_ops, "k": k,
            "maintain_every": maintain_every,
        },
        "device": str(dev),
        "service_device": str(svc.device),
        "tensor_devices": tensor_devices,
        "warmup_seconds": round(warmup_s, 3),
        "warmup_builds": [dataclasses.asdict(e) for e in cap.events
                          if e.slice_label in ("warmup", "slice0")],
        "compactions": store.compactions if store is not None else 0,
        "per_slice": per_slice,
        "total_rebuilds_after_warmup": sum(s["rebuilds"] for s in per_slice[1:]),
        "total_refreshes": sum(s["refreshes"] for s in per_slice),
        "steady_state": steady,
        "retraces": [r.to_json() for r in retraces],
    }


def findings_from_report(report: Dict, root) -> List[Finding]:
    """``recompile/growth-retrace`` findings, one per built object
    (``root`` is unused: the JAX signature, whose paths are found by grep).

    Keys must stay stable across schedule tweaks so the baseline does not
    churn: the snippet carries only the build name, causes/counts live in
    the message (and the full per-slice data in the JSON report).
    """
    by_closure: Dict[Tuple[str, str], List[Dict]] = {}
    for r in report["retraces"]:
        path = _closure_path(r["closure"])
        by_closure.setdefault((path, r["closure"]), []).append(r)

    findings = []
    for (path, closure), rs in sorted(by_closure.items()):
        causes = "; ".join(
            f"{r['cause']} {r['count']}x across {len(r['slices'])} slices "
            f"({r['detail']})" for r in rs
        )
        findings.append(Finding(
            rule="recompile/growth-retrace",
            path=path,
            line=0,
            message=f"{closure} is rebuilt on growth: {causes}",
            snippet=f"{closure} rebuilds on growth",
        ))
    return findings
