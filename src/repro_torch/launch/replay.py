"""Sharded traffic-replay CLI (twin of ``repro.launch.replay``).

Replays a generated evaluation log against a partitioning over a process
group with :func:`repro_torch.core.traffic_sharded.replay_sharded`, checks
the result bit for bit against the batched engine, and reports throughput:
the first (cold) replay and the second, which folds the log's resident
state. ``--degraded-check`` also replays through a
:class:`~repro_torch.core.framework.PartitionedGraphService` with the last
shard marked failed: the degraded fallback (the batched engine) must equal
the healthy sharded replay, and the service's health report gives the
degraded-operation count.

Alone, the command opens a group of one rank over a ``HashStore`` (NCCL on
the card, gloo with ``--device cpu``). Under ``torchrun`` it joins the
group torchrun describes (``env://``). ``--force-host-devices N`` (with
``--device cpu``) fakes an N-rank platform on a host without a card, as
the JAX launcher fakes N devices: the command starts N processes
(``torch.multiprocessing``) in a gloo group over a ``FileStore`` in a
temporary directory; it refuses inside an open group or under
``torchrun``. However the ranks start, every rank runs the same replay and
rank 0 prints the JSON.

    PYTHONPATH=src python -m repro_torch.launch.replay --dataset gis --n-ops 2000
    PYTHONPATH=src python -m repro_torch.launch.replay --dataset gis --device cpu \\
        --force-host-devices 4 --degraded-check
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.replay \\
        --dataset gis --device cpu --degraded-check
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device

COUNTERS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _forced_rank(rank: int, world: int, tmp: str, args: argparse.Namespace) -> None:
    """One of ``--force-host-devices``' ranks: join the gloo group over the
    ``FileStore`` in ``tmp``, run the replay; rank 0 leaves its JSON in
    ``tmp`` for the parent."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=120))
    try:
        out = _replay(args, torch.device("cpu"))
        if rank == 0:
            with open(os.path.join(tmp, "out.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _force_host(args: argparse.Namespace) -> dict:
    import torch.multiprocessing as mp

    world = int(args.force_host_devices)
    with tempfile.TemporaryDirectory(prefix="replay_ranks_") as tmp:
        mp.spawn(_forced_rank, args=(world, tmp, args), nprocs=world)
        with open(os.path.join(tmp, "out.json")) as f:
            return json.load(f)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="gis", choices=("filesystem", "gis", "twitter"))
    ap.add_argument("--pattern", default=None, help="access pattern (default: the dataset's)")
    ap.add_argument("--n-ops", type=int, default=2_000)
    ap.add_argument("--scale", type=float, default=0.004)
    ap.add_argument("--k", type=int, default=4, help="partition count")
    ap.add_argument("--partitioner", default="random", choices=("random", "didic"))
    ap.add_argument("--shards", type=int, default=None,
                    help="data shards (default and only value: the world size)")
    ap.add_argument("--force-host-devices", type=int, default=None,
                    help="fake an N-rank platform on the CPU: N processes in a gloo group "
                         "(needs --device cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the bit-exactness check against the batched engine")
    ap.add_argument("--degraded-check", action="store_true",
                    help="also replay through a service with one failed shard and check "
                         "that the degraded fallback is bit-equal")
    args = ap.parse_args(argv)
    if args.force_host_devices is not None:
        if args.force_host_devices < 1:
            ap.error("--force-host-devices takes a rank count >= 1")
        if args.device != "cpu":
            ap.error("--force-host-devices fakes ranks on the CPU: pass --device cpu")
        if dist.is_initialized() or "WORLD_SIZE" in os.environ:
            ap.error("--force-host-devices starts its own ranks: not inside an open process "
                     "group or under torchrun")
        return _force_host(args)

    from repro_torch.launch.mesh import open_group

    dev = resolve_device(args.device)
    opened = open_group(dev)
    try:
        return _replay(args, dev)
    finally:
        if opened:
            dist.destroy_process_group()


def _replay(args: argparse.Namespace, dev: torch.device) -> dict:
    """The replay on an open group: every rank runs it, rank 0 prints."""
    from repro_torch.core import partitioners
    from repro_torch.core.didic import DidicConfig, didic_partition
    from repro_torch.core.traffic import execute_ops, generate_ops
    from repro_torch.core.traffic_sharded import replay_sharded
    from repro_torch.graphs import datasets
    from repro_torch.launch.mesh import make_replay_mesh

    mesh = make_replay_mesh(args.shards, device=dev)
    graph = datasets.load(args.dataset, scale=args.scale)
    ops = generate_ops(graph, n_ops=args.n_ops, seed=args.seed, pattern=args.pattern)
    if args.partitioner == "didic":
        parts, _ = didic_partition(graph, DidicConfig(k=args.k, iterations=40),
                                   seed=args.seed, device=dev)
    else:
        parts = partitioners.random_partition(graph.n_nodes, args.k, seed=args.seed)

    times = []
    for _ in range(2):  # cold, then the resident fold
        _sync(dev)
        t0 = time.perf_counter()
        res = replay_sharded(graph, ops, mesh, parts, args.k)
        _sync(dev)
        times.append(time.perf_counter() - t0)

    if not args.no_verify:
        ref = execute_ops(graph, ops, parts, args.k, engine="batched", device=dev)
        for f in COUNTERS:
            if not np.array_equal(getattr(res, f), getattr(ref, f)):
                raise SystemExit(f"sharded replay diverged from batched on {f}")

    out = {
        "dataset": args.dataset, "pattern": ops.pattern, "n_ops": ops.n_ops,
        "shards": mesh.size, "device": str(dev),
        "cold_s": times[0], "resident_s": times[1],
        "ops_per_s": ops.n_ops / times[1], "cold_ops_per_s": ops.n_ops / times[0],
        "total_traffic": res.total, "percent_global": res.percent_global,
        "verified": not args.no_verify,
    }
    if args.degraded_check:
        from repro_torch.core.framework import PartitionedGraphService

        svc = PartitionedGraphService(graph, args.k, mesh=mesh)
        svc.partition_with(parts)
        svc.mark_shard_failed(mesh.size - 1)
        deg = svc.run_ops(ops)
        for f in COUNTERS:
            if not np.array_equal(getattr(deg, f), getattr(res, f)):
                raise SystemExit(f"degraded fallback diverged on {f}")
        out["degraded"] = svc.logger.health_report()
    if mesh.rank == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
