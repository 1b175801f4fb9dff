"""DiDiC-partition-aware distributed GNN training (twin of
``examples/distributed_gnn_training.py``).

Partitions a graph with DiDiC, places each partition on one data shard (a
rank of the process group), trains a GCN whose message passing runs
through the halo exchange (the thesis's Shadow Construct) and reports the
collective volume DiDiC saves against a random placement.

Each rank holds its block of the partitioned layout. Its loss is its
masked NLL sum over the mask count of every data shard, so the shards'
losses sum to the example's mean; the halo exchange carries the gradient
back to the shards that exported each boundary row, and the parameter
gradients are summed over the data axis, so every rank applies the same
AdamW update. On a mesh with a model axis, the ranks of one data column
hold the same shard and compute the same.

Alone, the command opens a group of one rank (NCCL on the card, gloo with
``--device cpu``); under ``torchrun`` every rank takes one shard:

    PYTHONPATH=src python -m repro_torch.distributed_gnn_training [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.distributed_gnn_training --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.data.pipeline import gnn_features
from repro_torch.distributed.halo import HaloProgram, build_halo_program, make_partitioned_spmm
from repro_torch.distributed.placement import PartitionedLayout, build_layout, collective_bytes_estimate
from repro_torch.distributed.sharding import gnn_node_spec, shard_tree
from repro_torch.graphs.structure import Graph
from repro_torch.models import gnn
from repro_torch.optim import adamw

D_FEAT, N_CLASSES, D_HIDDEN = 32, 4, 32
OPT = adamw.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=60, weight_decay=0.0)
CFG = gnn.GnnConfig(kind="gcn", d_in=D_FEAT, d_hidden=D_HIDDEN, d_out=N_CLASSES)


def halo_table(graph: Graph, placements: Dict[str, np.ndarray],
               d_feat: int = D_HIDDEN) -> Dict[str, Tuple[float, float]]:
    """Each placement's (halo bytes a step, edge-cut fraction)."""
    return {name: collective_bytes_estimate(graph, parts, d_feat=d_feat)
            for name, parts in placements.items()}


@dataclasses.dataclass
class GcnRun:
    """A training run on this rank: every step's loss (the sum over the
    ranks, the example's mean), the (step, loss, accuracy) lines the
    example prints, the layout and halo program, and the training loop's
    seconds (ending in a device synchronize)."""

    losses: List[float]
    evals: List[Tuple[int, float, float]]
    layout: PartitionedLayout
    program: HaloProgram
    seconds: float


def _forward(params, x: torch.Tensor, spmm) -> torch.Tensor:
    h = x
    for i in range(CFG.n_layers):
        h = h @ params[f"w{i}"]
        h = spmm(h) + h  # halo-exchange aggregation + self loop
        if i < CFG.n_layers - 1:
            h = torch.relu(h)
    return h


def train(graph: Graph, parts: np.ndarray, mesh, steps: int = 60, params=None,
          seed: int = 0) -> GcnRun:
    """Train the example's 2-layer GCN for ``steps`` AdamW steps on this
    rank's shard of ``graph``, placed by ``parts`` (k partitions folded
    onto the mesh's ``data`` shards). ``params`` defaults to a seeded
    ``gcn_init`` on the mesh's device; every rank must pass the same."""
    dev = mesh.device
    layout = build_layout(graph, parts, mesh.shape["data"])
    prog = build_halo_program(graph, layout)
    spmm = make_partitioned_spmm(prog, mesh)

    x_host, labels_host = gnn_features(graph.n_nodes, D_FEAT, N_CLASSES, seed=0)
    whole = {"x": torch.as_tensor(layout.scatter_features(x_host)),
             "y": torch.as_tensor(layout.scatter_features(labels_host.astype(np.int32), fill=-1)[:, None])}
    spec = gnn_node_spec(mesh)
    local = shard_tree(whole, {"x": spec, "y": spec}, mesh)
    x, y = local["x"].to(dev), local["y"][:, 0].to(dev).long()
    mask = (y >= 0).to(torch.float32)
    y = torch.clamp(y, min=0)
    count = torch.clamp(mesh.all_reduce(mask.sum(), axis="data"), min=1.0)

    if params is None:
        params = gnn.gcn_init(CFG, torch.Generator(device=dev).manual_seed(seed), device=dev)
    state = adamw.init(params)
    names = list(params)

    def loss_of(p):
        logp = torch.log_softmax(_forward(p, x, spmm).float(), dim=-1)
        nll = -torch.gather(logp, 1, y[:, None])[:, 0]
        return (nll * mask).sum() / count

    losses, evals = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        leaves = {k: params[k].detach().requires_grad_() for k in names}
        loss = loss_of(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads] + [loss.detach()[None]]), axis="data")
        sizes = [g.numel() for g in grads]
        parts_ = flat[:-1].split(sizes)
        params, state, _ = adamw.update(params, {k: t.view_as(params[k]) for k, t in zip(names, parts_)},
                                        state, OPT)
        losses.append(flat[-1])
        if step % 15 == 0 or step == steps - 1:
            with torch.no_grad():
                hit = ((torch.argmax(_forward(params, x, spmm), -1) == y) * mask).sum()
                evals.append((step, flat[-1], mesh.all_reduce(hit, axis="data") / count))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return GcnRun(losses=[float(v) for v in losses],
                  evals=[(s, float(v), float(a)) for s, v, a in evals],
                  layout=layout, program=prog, seconds=seconds)


def main(argv: Optional[Sequence[str]] = None) -> GcnRun:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="gis", choices=("filesystem", "gis", "twitter"))
    ap.add_argument("--scale", type=float, default=0.003)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.core import partitioners
    from repro_torch.core.didic import DidicConfig, didic_partition
    from repro_torch.graphs import datasets
    from repro_torch.launch.mesh import make_host_mesh, open_group

    dev = resolve_device(args.device)
    opened = open_group(dev)
    try:
        mesh = make_host_mesh(device=dev)
        say = print if mesh.rank == 0 else (lambda *a, **k: None)
        graph = datasets.load(args.dataset, scale=args.scale)
        say(graph.summary())
        k = 4  # the example's partitions; they fold onto the ranks' shards
        didic_parts, _ = didic_partition(graph, DidicConfig(k=k, iterations=40), seed=0, device=dev)
        rand_parts = partitioners.random_partition(graph.n_nodes, k, seed=0)
        for name, (b, ec) in halo_table(graph, {"random": rand_parts, "didic": didic_parts}).items():
            say(f"  placement/{name}: edge_cut={ec * 100:5.1f}%  halo≈{b / 1e6:.2f} MB/step")
        run = train(graph, didic_parts, mesh, steps=args.steps)
        prog = run.program
        say(f"  halo program ({mesh.size} shard(s)): block={prog.block} B_max={prog.b_max} "
            f"G_max={prog.g_max} collective={prog.halo_bytes(D_HIDDEN) / 1e6:.2f} MB/step")
        for step, loss, acc in run.evals:
            say(f"  step {step:3d}: loss={loss:.4f} acc={acc:.3f}")
        say(f"\nDistributed GCN trained over DiDiC-placed shards with halo exchange "
            f"({args.steps} steps in {run.seconds:.2f} s, {dev.type}).")
        return run
    finally:
        if opened:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
