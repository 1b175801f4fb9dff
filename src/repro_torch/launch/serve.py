"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Twin of ``repro.launch.serve``: the continuous-batching LM engine on a
reduced config of an LM arch (2 layers, d_model 128, 8 heads, the arch's
kv-head ratio, vocab 512; dense for the MoE archs too, as the JAX launcher
builds it, so both give the same tokens), DIN scoring and retrieval at a reduced size
(10,000 items, 100 categories, history 50), or online graph serving
(``--arch graph``: seeded clients over the partitioned GIS service at
``scale=0.002`` on a mesh over the process group, fixed-slot admission
batches replayed sharded, background DiDiC maintenance shared by every
rank), with the same sizes and seeds as the JAX launcher. Runs on the card
unless ``--device cpu`` is given. ``--arch graph`` alone opens a group of
one rank (NCCL on the card, gloo on the CPU); under ``torchrun`` every rank
serves the same stream and rank 0 prints.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch din --requests 4096 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch graph --requests 256 --arrival bursty
"""

from __future__ import annotations

import argparse
import importlib
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device

#: arch id → (family, config module) of every arch; the ``gnn`` family is
#: trained only (``launch.train``), as in the JAX package.
ARCHS = {
    "granite-3-8b": ("lm", "repro_torch.configs.granite_3_8b"),
    "yi-34b": ("lm", "repro_torch.configs.yi_34b"),
    "deepseek-coder-33b": ("lm", "repro_torch.configs.deepseek_coder_33b"),
    "deepseek-moe-16b": ("lm", "repro_torch.configs.deepseek_moe_16b"),
    "qwen3-moe-30b-a3b": ("lm", "repro_torch.configs.qwen3_moe_30b_a3b"),
    "din": ("recsys", "repro_torch.configs.din"),
    "gcn-cora": ("gnn", "repro_torch.configs.gcn_cora"),
    "graphsage-reddit": ("gnn", "repro_torch.configs.graphsage_reddit"),
    "meshgraphnet": ("gnn", "repro_torch.configs.meshgraphnet"),
    "mace": ("gnn", "repro_torch.configs.mace"),
}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(arch: str, n_requests: int, device=None) -> float:
    """Serve ``n_requests`` seeded requests; returns tokens per second."""
    from repro_torch.models.transformer import TransformerConfig, init_params
    from repro_torch.serving.engine import Request, ServingEngine

    dev = resolve_device(device)
    full: TransformerConfig = importlib.import_module(ARCHS[arch][1]).FULL
    # No ``moe=``: the JAX launcher serves a dense reduced config of every arch.
    cfg = TransformerConfig(
        name=arch + "-serve", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=max(1, 8 * full.n_kv_heads // full.n_heads), d_ff=256, vocab=512,
    )
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=128, device=dev)
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(1, 512, size=rng.integers(2, 8)), max_new_tokens=16)
        for _ in range(n_requests)
    ]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in reqs)
    if not all(r.done for r in reqs):
        raise RuntimeError("the engine drained with requests still open")
    print(f"[serve] {arch}: {n_requests} requests, {toks} tokens, "
          f"{toks / dt:.1f} tok/s (continuous batching over 4 slots, {dev.type})")
    return toks / dt


def serve_din(n_requests: int, device=None) -> float:
    """Score ``n_requests`` seeded requests, then one user against 100,000
    candidates; returns requests per second."""
    from repro_torch.data.pipeline import din_batch
    from repro_torch.models import recsys

    dev = resolve_device(device)
    cfg = recsys.DinConfig(n_items=10_000, n_cats=100, seq_len=50)
    params = recsys.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in din_batch(n_requests, 50, 10_000, 100).items()}
    with torch.no_grad():
        recsys.forward(cfg, params, b)  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        logits = recsys.forward(cfg, params, b)
        _sync(dev)
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("DIN scoring gave non-finite logits")
        print(f"[serve] din: scored {n_requests} requests in {dt * 1e3:.1f} ms "
              f"({n_requests / dt:.0f} req/s, {dev.type})")
        uv = recsys.user_vector(cfg, params, b)
        cand = torch.arange(100_000, device=dev) % cfg.n_items
        t0 = time.perf_counter()
        scores = recsys.retrieval_scores(cfg, params, uv[:1], cand, cand % cfg.n_cats)
        _sync(dev)
        print(f"[serve] din retrieval: 1x{scores.shape[1]} candidates in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return n_requests / dt


def serve_graph(n_requests: int, arrival: str, seed: int = 0, device=None):
    """Online graph serving: seeded clients → admission loop → report.
    Returns the server's :class:`~repro_torch.core.online.OnlineRunResult`."""
    from repro_torch.core.didic import DidicConfig
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.online import BackgroundMaintenance, OnlineServer, make_arrival_stream
    from repro_torch.graphs import datasets
    from repro_torch.launch.mesh import make_replay_mesh, open_group

    dev = resolve_device(device)
    opened = open_group(dev)
    try:
        graph = datasets.load("gis", scale=0.002, seed=seed)
        mesh = make_replay_mesh(device=dev)
        k = 4
        svc = PartitionedGraphService(graph, k, DidicConfig(k=k, iterations=12), device=dev,
                                      mesh=mesh, maintenance="shared").partition_didic(seed=seed)
        arrivals, t_counts = make_arrival_stream(
            graph, ("gis_short", "gis_long"), n_requests, seed=seed, process=arrival,
        )
        server = OnlineServer(
            svc, batch_slots=8, queue_limit=64,
            maintenance=BackgroundMaintenance(svc, every=8),
            slo={"gis_short": 8, "gis_long": 16},
        )
        server.submit_stream(arrivals, t_counts)
        t0 = time.perf_counter()
        result = server.run()
        _sync(dev)
        dt = time.perf_counter() - t0
    finally:
        if opened:
            dist.destroy_process_group()
    if mesh.rank == 0:
        print(f"[serve] graph/{arrival}: {result.ops_served} ops in "
              f"{result.batches_served} batches over {result.ticks} ticks on {mesh.size} "
              f"shard(s), {result.ops_served / dt:.1f} ops/s ({dev.type})")
        for cls, rep in result.latency.items():
            print(f"[serve]   {cls}: wait p50={rep['queue_wait_p50']} "
                  f"p99={rep['queue_wait_p99']} ticks (count={rep['count']})")
        print(f"[serve]   slo_violations={result.health['slo_violations']}")
    return result


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arrival", default="uniform", choices=("uniform", "bursty", "skewed_hot"),
                    help="arrival process for --arch graph")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.arch == "graph":
        serve_graph(args.requests, args.arrival, device=args.device)
        return
    if args.arch not in ARCHS:
        raise KeyError(f"unknown arch {args.arch!r}; have {sorted(ARCHS)}")
    family = ARCHS[args.arch][0]
    if family == "lm":
        serve_lm(args.arch, args.requests, args.device)
    elif family == "recsys":
        serve_din(args.requests, args.device)
    else:
        raise SystemExit(f"{args.arch} ({family}) has no serving path; use train")


if __name__ == "__main__":
    main()
