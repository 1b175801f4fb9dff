"""Profile a replay of the GIS evaluation log on the card.

    PYTHONPATH=src python -m repro_torch.profile_replay              # scale 1.0
    PYTHONPATH=src python -m repro_torch.profile_replay --device cpu --scale 0.002

Partitions GIS with DiDiC (k=4, ``smooth_cap`` 64, as in the paper's
static experiment), takes the first ``--n-ops`` ops of the 10,000-op evaluation
log, replays them once to warm the log's caches, then replays them again
under ``torch.profiler`` and prints one JSON line: the wall time, the time
the card was busy, their ratio and the device kernels that took the most
time. The profiler's own overhead lengthens the wall time, so the busy
share is a lower bound. On the CPU no device time is recorded.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.didic import DidicConfig
from repro_torch.core.framework import PartitionedGraphService
from repro_torch.core.traffic import OpLog, execute_ops
from repro_torch.graphs import datasets


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--n-ops", type=int, default=1000)
    ap.add_argument("--didic-iterations", type=int, default=100)
    args = ap.parse_args(argv)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(args.device)
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
    execute_ops(graph, sub, parts, k, device=dev)  # warm the log's caches
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        execute_ops(graph, sub, parts, k, device=dev)
        sync()
    wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    record = {
        "profile": f"{graph.name} {ops.pattern} replay, first {sub.n_ops} ops, DiDiC parts",
        "device": str(dev), "wall_s": wall, "device_busy_s": busy,
        "device_busy_share": busy / wall if kern else None,
        "top_device_kernels_ms_count": [
            [e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top],
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
