"""Profile the main paths' kernels where they run: the GIS replay and DIN's
user tower.

    PYTHONPATH=src python -m repro_torch.profile_replay [--din]      # scale 1.0
    PYTHONPATH=src python -m repro_torch.profile_replay --device cpu --scale 0.002 --n-ops 50

**GIS.** Partitions GIS with DiDiC (k=4, ``smooth_cap`` 64, as in the
paper's static experiment) and takes the first ``--n-ops`` ops of the
10,000-op evaluation log. It replays them once to warm the log's caches,
then times a replay without the engine's row schedule and one with it
(host clock ending in a synchronize), then replays them under
``torch.profiler`` with the schedule and again without. Each call of
``frontier_gather`` and of the engine's ``row_order`` runs inside a
profiler range named by its row count (a window's padded size), so the
profile gives, per row count: the calls, the device time of the call's
kernels with and without the schedule, and the schedule's. The device
kernels' totals by name split a call's time between the gather and its
spill-tail kernel. The wrapper's host time per call (its checks, the
output's allocation and the ``ctypes`` launch) is taken on the host clock
in the timed replay with the schedule, outside the profiler.

**DIN** (with ``--din``). Builds ``configs/din.FULL`` and 262,144
requests, calls ``user_vector`` twice to warm it, then five times under
the profiler: the device time and the wrapper's host time of each of its
two ``embedding_bag`` calls.

Prints one JSON line for each and returns the GIS one. The profiler's own
overhead lengthens the wall time, so the busy share is a lower bound. On
the CPU no device time is recorded.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.didic import DidicConfig
from repro_torch.core.framework import PartitionedGraphService
from repro_torch.core.traffic import OpLog, execute_ops
from repro_torch.core.traffic_batched import BatchedTrafficEngine, get_engine
from repro_torch.graphs import datasets
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.frontier import ops as frontier_ops


@contextlib.contextmanager
def traced(owner, name: str, label: Callable[..., str], calls: List):
    """Run every call of ``owner.name`` inside a profiler range named
    ``label(*args)`` and append ``(label, host seconds)`` to ``calls``."""
    from torch.profiler import record_function

    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        tag = label(*args, **kwargs)
        with record_function(tag):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            calls.append((tag, time.perf_counter() - t0))
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, fn)


@contextlib.contextmanager
def traced_gis(calls: List):
    with contextlib.ExitStack() as stack:
        stack.enter_context(traced(frontier_ops, "frontier_gather",
                                   lambda x, nbr, *a, **k: f"frontier_gather[{nbr.shape[0]}]", calls))
        stack.enter_context(traced(BatchedTrafficEngine, "row_order",
                                   lambda self, win_t, w_pad: f"row_order[{w_pad}]", calls))
        yield


def _profile(fn, on_card: bool):
    """Run ``fn`` under the profiler; return (wall s, {range: (count, device
    µs, host µs)}, device busy s, {kernel name: [device ms, count]})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        fn()
        sync()
    wall = time.perf_counter() - t0
    avg = prof.key_averages()
    ranges = {e.key: (e.count, e.device_time_total, e.cpu_time_total) for e in avg
              if e.key.endswith("]") and "[" in e.key}
    kern = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = {e.key[:90]: [e.self_device_time_total / 1e3, e.count]
           for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]}
    return wall, ranges, busy, top


def _by_rows(ranges: Dict, prefix: str) -> Dict[int, tuple]:
    return {int(k[len(prefix) + 1:-1]): v for k, v in ranges.items() if k.startswith(prefix + "[")}


def _median_host_us(calls: List, prefix: str) -> Dict[int, float]:
    per: Dict[int, List[float]] = {}
    for tag, s in calls:
        if tag.startswith(prefix + "["):
            per.setdefault(int(tag[len(prefix) + 1:-1]), []).append(s * 1e6)
    return {rows: statistics.median(v) for rows, v in per.items()}


def profile_gis(args, dev) -> dict:
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    k = 4
    graph = datasets.load("gis", scale=args.scale, seed=0)
    config = DidicConfig(k=k, iterations=args.didic_iterations, smooth_cap=64)
    svc = PartitionedGraphService(graph, k, config, device=dev)
    ops = svc.make_ops(n_ops=10_000, seed=0)
    parts = svc.partition_didic(seed=0).parts.copy()
    sub = OpLog(ops.pattern, ops.starts[:args.n_ops].copy(), ops.ends[:args.n_ops].copy(),
                ops.t_l, ops.t_pg)
    engine = get_engine(graph, ops.pattern, device=dev)
    if args.order_min_rows is not None:
        engine.order_min_rows = args.order_min_rows
    scheduled = engine.order_min_rows

    def replay():
        return execute_ops(graph, sub, parts, k, device=dev)

    def timed_replay():
        sync()
        t0 = time.perf_counter()
        replay()
        sync()
        return time.perf_counter() - t0

    replay()  # warm the log's caches and the whole-graph layout
    engine.order_min_rows = 1 << 62
    unordered_s = timed_replay()
    engine.order_min_rows = scheduled
    host_calls: List = []
    with traced_gis(host_calls):
        ordered_s = timed_replay()
    with traced_gis([]):
        wall, ranges, busy, top = _profile(replay, on_card)
        engine.order_min_rows = 1 << 62
        wall_u, ranges_u, busy_u, top_u = _profile(replay, on_card)
        engine.order_min_rows = scheduled

    gather, gather_u = _by_rows(ranges, "frontier_gather"), _by_rows(ranges_u, "frontier_gather")
    order = _by_rows(ranges, "row_order")
    host_gather = _median_host_us(host_calls, "frontier_gather")
    host_order = _median_host_us(host_calls, "row_order")
    buckets = []
    for rows in sorted(gather):
        n, dev_us, _ = gather[rows]
        buckets.append({
            "rows": rows, "launches": n, "scheduled": rows >= scheduled,
            "kernel_ms": dev_us / 1e3, "kernel_unscheduled_ms": gather_u.get(rows, (0, 0.0))[1] / 1e3,
            "row_order_calls": order.get(rows, (0, 0.0))[0],
            "row_order_device_ms": order.get(rows, (0, 0.0))[1] / 1e3,
            "row_order_host_us_median": host_order.get(rows),
            "wrapper_host_us_median": host_gather.get(rows),
        })
    launches = sum(b["launches"] for b in buckets)
    record = {
        "profile": f"{graph.name} {ops.pattern} replay, first {sub.n_ops} ops, DiDiC parts",
        "device": str(dev), "order_min_rows": scheduled,
        "replay_s": ordered_s, "ops_per_s": sub.n_ops / ordered_s,
        "replay_unscheduled_s": unordered_s, "ops_per_s_unscheduled": sub.n_ops / unordered_s,
        "wall_s": wall, "device_busy_s": busy,
        "device_busy_share": busy / wall if on_card else None,
        "profiled_wall_unscheduled_s": wall_u, "device_busy_unscheduled_s": busy_u,
        "frontier_gather_launches": launches,
        "frontier_gather_device_ms": sum(b["kernel_ms"] for b in buckets),
        "frontier_gather_unscheduled_device_ms": sum(b["kernel_unscheduled_ms"] for b in buckets),
        "wrapper_host_us_median": statistics.median(
            [s * 1e6 for tag, s in host_calls if tag.startswith("frontier_gather[")] or [0.0]),
        "by_rows": buckets,
        "top_device_kernels_ms_count": top,
        "unscheduled_top_device_kernels_ms_count": top_u,
    }
    print(json.dumps(record), flush=True)
    return record


def profile_din(dev) -> dict:
    from repro_torch.configs.din import FULL
    from repro_torch.data.pipeline import din_batch
    from repro_torch.models import recsys

    on_card = dev.type == "cuda"
    n_req = 262_144
    params = recsys.init(FULL, torch.Generator(device=dev).manual_seed(0), device=dev)
    host = din_batch(n_req, FULL.seq_len, FULL.n_items, FULL.n_cats, seed=0)
    batch = {k: torch.as_tensor(a, device=dev) for k, a in host.items()}
    with torch.no_grad():
        for _ in range(2):
            recsys.user_vector(FULL, params, batch)
        calls: List = []
        label = lambda table, *a, **k: f"embedding_bag[{table.shape[0]}]"  # noqa: E731
        with traced(bag_ops, "embedding_bag", label, calls):
            wall, ranges, busy, top = _profile(
                lambda: [recsys.user_vector(FULL, params, batch) for _ in range(5)], on_card)
    tables = _by_rows(ranges, "embedding_bag")
    host_us = _median_host_us(calls, "embedding_bag")
    record = {
        "profile": f"{FULL.name} user_vector, {n_req} users", "device": str(dev),
        "profiled_wall_s": wall, "device_busy_s": busy, "user_vector_calls": 5,
        "top_device_kernels_ms_count": top,
        "embedding_bag": [{"table_rows": rows, "launches": n, "device_ms": d / 1e3,
                           "wrapper_host_us": host_us.get(rows)}
                          for rows, (n, d, _) in sorted(tables.items())],
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--n-ops", type=int, default=10_000)
    ap.add_argument("--didic-iterations", type=int, default=100)
    ap.add_argument("--order-min-rows", type=int, default=None,
                    help="windows of at least this many rows get the row schedule "
                         "(default: the engine's rule; 0 schedules every window)")
    ap.add_argument("--din", action="store_true", help="then profile DIN's user tower too")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    record = profile_gis(args, dev)
    if args.din:
        profile_din(dev)
    return record


if __name__ == "__main__":
    main()
