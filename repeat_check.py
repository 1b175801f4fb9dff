"""Run the graph side's float-summing paths twice on one card and report
whether the two runs agree bit for bit, with their times.

    python3 repeat_check.py [--root DIR] [--paths gnn,mesh_didic,gcn,dynamic]
    python3 repeat_check.py --device cpu --scale 0.01 --paths mesh_didic,gcn,dynamic

``DIR`` (default: this checkout) is the checkout whose port and
``chip_smoke.py`` are imported, for example the parent commit unpacked with
``git archive`` into a git-ignored directory, so that one call can read
two trees on one card. Each path runs on the same inputs twice in one
process:

* ``gnn`` (``chip_smoke.py`` phase 11a): gcn-cora, graphsage-reddit (a
  sampled 1,024-node batch, fanout 15-10), meshgraphnet and mace at their
  ``FULL`` widths (``chip_smoke._gnn_full``): the forward loss, then
  ``GNN_STEPS`` trainer steps from the same parameters (every loss and
  the final parameters); forward ms by CUDA events (median of 5), step ms
  the trainer's median;
* ``mesh_didic`` (phase 12 (d)): the mesh DiDiC on Twitter, 20
  iterations (``smooth_cap`` 64), on a group of one rank: ``parts`` and
  ``w``; seconds of each run;
* ``gcn`` (phase 13 (c)): the distributed GCN twin on GIS, a random
  4-way map folded onto the one shard, its first 5 steps: every loss;
  ms a step;
* ``dynamic`` (phase 18 (b)): the paper bench's Dynamic experiment on
  Twitter with the mesh DiDiC (``maintenance="auto"``) from the bench's own
  single-device DiDiC map: each round's T_G % and migrated count, the
  final map and the carried ``w``; seconds of each run.

Graphs are loaded at ``--scale`` (default 1.0, the chip's). On the card
the group is NCCL; with ``--device cpu`` it is gloo, times are host
seconds, and ``gnn`` is not run (its ``FULL`` configs are card sizes).
Prints one JSON line a path, then the card's ``nvidia-smi`` name and
power limit, then a JSON summary ``{"repeat": {path: bool}}``. Exits 1
when no CUDA device is present and ``--device`` is not ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

THIS = os.path.dirname(os.path.abspath(__file__))
PATHS = ("gnn", "mesh_didic", "gcn", "dynamic")
GCN_STEPS = 5


def _bits_equal(a, b) -> bool:
    """Same shape, dtype and bytes (NaN and the sign of zero included)."""
    import torch

    a, b = torch.as_tensor(a).detach().cpu(), torch.as_tensor(b).detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(ints), b.contiguous().view(ints)
    return bool(torch.equal(a, b))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _seconds(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _open_group(dev) -> None:
    import torch.distributed as dist

    if dev.type == "cuda":
        import torch

        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
                            rank=0, world_size=1)


def run_gnn(cs, dev):
    """Phase 11a twice: forward loss, then the trainer's steps."""
    import gc
    import itertools

    import torch

    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.launch.train import gnn_loss, sage_sampled_batch
    from repro_torch.optim.adamw import AdamWConfig, leaves, tree_map
    from repro_torch.train import Trainer, TrainerConfig

    out = {}
    for arch in cs.GNN_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg, g, p_cpu, b_cpu, _ = cs._gnn_full(arch, dev)
        params = tree_map(lambda t: t.to(dev), p_cpu)
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        loss_fn = lambda p, b, cfg=cfg: gnn_loss(cfg, p, b)  # noqa: E731
        if arch == "graphsage-reddit":
            shape = GNN_SHAPES["minibatch_lg"]
            ns = NeighborSampler(g, shape["fanout"], seed=0)
            batches = [sage_sampled_batch(ns.sample_batch(nodes), b_dev["x"], b_dev["labels"])
                       for nodes in ns.batches(shape["batch_nodes"], cs.GNN_STEPS, seed=1)]
        else:
            batches = list(itertools.repeat(b_dev, cs.GNN_STEPS))
        with torch.no_grad():
            fwd_ms, first = cs.time_cuda(lambda: loss_fn(params, batches[0]), reps=5, warmup=1)
            second = loss_fn(params, batches[0])
        runs = []
        for _ in range(2):
            tr = Trainer(loss_fn, params,
                         AdamWConfig(lr=cs.GNN_LR, warmup_steps=1, total_steps=cs.GNN_STEPS, weight_decay=0.0),
                         TrainerConfig(total_steps=cs.GNN_STEPS, log_every=1))
            tr.fit(iter(batches))
            runs.append(([m["loss"] for m in tr.metrics_log], leaves(tr.state["params"]),
                         statistics.median(m["step_time_s"] for m in tr.metrics_log) * 1e3))
            del tr
        (l1, p1, ms1), (l2, p2, ms2) = runs
        out[arch] = {
            "forward_equal": _bits_equal(first, second), "forward": [float(first), float(second)],
            "forward_ms": fwd_ms, "losses_equal": l1 == l2, "params_equal": all(map(_bits_equal, p1, p2)),
            "losses": [l1, l2], "step_ms": [ms1, ms2],
        }
        del params, b_dev, batches
    return out, all(r["forward_equal"] and r["losses_equal"] and r["params_equal"] for r in out.values())


def run_mesh_didic(cs, dev, scale):
    """Phase 12 (d) twice: the mesh DiDiC on Twitter, 20 iterations."""
    import torch.distributed as dist

    from repro_torch.core import didic_distributed as dd
    from repro_torch.core.didic import DidicConfig
    from repro_torch.graphs import datasets
    from repro_torch.launch.mesh import make_replay_mesh

    g = datasets.load("twitter", scale=scale, seed=0)
    cfg = DidicConfig(k=4, iterations=20, smooth_cap=64)
    states = []
    run_mesh = dd._run_mesh

    def keep_state(*a, **k):  # the partition returns the map only; keep its final loads
        states.append(run_mesh(*a, **k))
        return states[-1]

    _open_group(dev)
    dd._run_mesh = keep_state
    try:
        mesh = make_replay_mesh(device=dev)
        runs = [_seconds(lambda: dd.didic_partition_distributed(g, cfg, mesh, seed=0)[0], dev)
                for _ in range(2)]
    finally:
        dd._run_mesh = run_mesh
        dist.destroy_process_group()
    (p1, t1), (p2, t2) = runs
    s1, s2 = states
    rec = {"parts_equal": bool((p1 == p2).all()), "w_equal": _bits_equal(s1.w, s2.w),
           "parts_differ": int((p1 != p2).sum()), "w_max_abs_diff": float((s1.w - s2.w).abs().max()),
           "seconds": [t1, t2], "nodes": g.n_nodes}
    return rec, rec["parts_equal"] and rec["w_equal"]


def run_gcn(cs, dev, scale):
    """Phase 13 (c) twice: the distributed GCN's first steps."""
    import torch
    import torch.distributed as dist

    from repro_torch import distributed_gnn_training as twin
    from repro_torch.core import partitioners
    from repro_torch.graphs import datasets
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gnn

    g = datasets.load("gis", scale=scale, seed=0)
    parts = partitioners.random_partition(g.n_nodes, 4, seed=0)
    params0 = gnn.gcn_init(twin.CFG, torch.Generator().manual_seed(0), device="cpu")
    _open_group(dev)
    try:
        mesh = make_host_mesh(device=dev)
        runs = [twin.train(g, parts, mesh, steps=GCN_STEPS, params={k: v.to(dev) for k, v in params0.items()})
                for _ in range(2)]
    finally:
        dist.destroy_process_group()
    rec = {"losses_equal": runs[0].losses == runs[1].losses, "losses": [r.losses for r in runs],
           "step_ms": [r.seconds / GCN_STEPS * 1e3 for r in runs], "nodes": g.n_nodes}
    return rec, rec["losses_equal"]


def run_dynamic(cs, dev, scale):
    """Phase 18 (b) twice: the Dynamic experiment on the mesh DiDiC."""
    import torch.distributed as dist

    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.launch.mesh import make_replay_mesh
    from repro_torch.paper_tables import DYNAMIC_SLICES, PaperBench

    bench = PaperBench(PaperExperimentConfig(scale=scale, n_ops=cs.N_OPS, datasets=("twitter",)), device=dev)
    _, map_s = _seconds(lambda: bench.partition("twitter", "didic", 4), dev)
    ops = bench.ops("twitter")
    _open_group(dev)
    try:
        mesh = make_replay_mesh(device=dev)
        runs = []
        for _ in range(2):
            rt = bench._runtime_for("twitter", 4, "random", mesh=mesh)
            res, secs = _seconds(lambda: rt.run(ops, n_slices=DYNAMIC_SLICES, amount=0.05, maintain_every=1), dev)
            runs.append(([r.percent_global for r in res.records], [r.migrated for r in res.records],
                         rt.service.parts.copy(), rt.service.runtime.state.w.detach().cpu(), secs))
    finally:
        dist.destroy_process_group()
    (pg1, mv1, p1, w1, t1), (pg2, mv2, p2, w2, t2) = runs
    rec = {"rounds_equal": pg1 == pg2, "migrated_equal": mv1 == mv2, "parts_equal": bool((p1 == p2).all()),
           "w_equal": _bits_equal(w1, w2), "percent_global": [pg1, pg2], "migrated": [mv1, mv2],
           "seconds": [t1, t2], "map_s": map_s, "nodes": int(p1.shape[0])}
    return rec, rec["rounds_equal"] and rec["migrated_equal"] and rec["parts_equal"] and rec["w_equal"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=THIS, help="the checkout to import the port and chip_smoke.py from")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    paths = [p for p in args.paths.split(",") if p]
    for p in paths:
        if p not in PATHS:
            ap.error(f"unknown path {p!r}; choose from {', '.join(PATHS)}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs  # inserts ROOT/src of that checkout

    if args.device == "cuda" and not torch.cuda.is_available():
        print("repeat_check.py: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.device == "cpu" and "gnn" in paths:
        ap.error("the gnn path runs FULL configs: card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from repro_torch import kernels

        kernels.build_all()
    summary = {}
    for p in paths:
        t0 = time.perf_counter()
        if p == "gnn":
            rec, same = run_gnn(cs, dev)
        else:
            rec, same = {"mesh_didic": run_mesh_didic, "gcn": run_gcn, "dynamic": run_dynamic}[p](cs, dev, args.scale)
        summary[p] = same
        print(json.dumps({"path": p, "root": root, "repeat": same, "path_s": time.perf_counter() - t0, **rec}),
              flush=True)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps({"repeat": summary, "root": root}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
