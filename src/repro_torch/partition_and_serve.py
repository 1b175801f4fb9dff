"""End-to-end driver: build the paper's three datasets, partition them with
every method, serve their access-pattern logs, apply dynamism and repair it
with DiDiC — the Static → Insert → Stress → Dynamic lifecycle of Chapter 7.

Twin of ``examples/partition_and_serve.py``, on the port:

    PYTHONPATH=src python -m repro_torch.partition_and_serve              # on the card
    PYTHONPATH=src python -m repro_torch.partition_and_serve --device cpu --scale 0.002
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs.paper_didic import PaperExperimentConfig
from repro_torch.core import metrics, partitioners
from repro_torch.core.didic import didic_partition
from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
from repro_torch.core.dynamism import apply_dynamism, generate_dynamism
from repro_torch.core.framework import PartitionedGraphService
from repro_torch.graphs import datasets


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--k", type=int, default=4)
    args = ap.parse_args(argv)
    cfg = PaperExperimentConfig(scale=args.scale)
    k = args.k

    for name in cfg.datasets:
        graph = datasets.load(name, scale=cfg.scale)
        print(f"\n=== {name}: {graph.summary()}", flush=True)
        didic_cfg = cfg.didic(name, k)
        svc = PartitionedGraphService(graph, k, didic=didic_cfg, device=args.device)
        n_ops = cfg.n_ops_gis if name == "gis" else cfg.n_ops
        ops = svc.make_ops(n_ops=n_ops, seed=0)

        # --- Static experiment: three partitioning methods
        didic_parts, state = didic_partition(graph, didic_cfg, seed=0, device=args.device)
        results = {}
        for method in ("random", "didic", "hardcoded"):
            if method == "random":
                parts = partitioners.random_partition(graph.n_nodes, k, seed=0)
            elif method == "didic":
                parts = didic_parts
            else:
                parts = partitioners.hardcoded_for(graph, k)
                if parts is None:
                    continue
            svc.partition_with(parts)
            res = svc.run_ops(ops)
            results[method] = res
            print(f"  static/{method:9s}: ec={metrics.edge_cut_fraction(graph, parts)*100:5.1f}% "
                  f"T_G%={res.percent_global*100:6.2f}%")
        red = (1 - results["didic"].percent_global / max(results["random"].percent_global, 1e-9)) * 100
        print(f"  → DiDiC traffic reduction vs random: {red:.0f}% (paper band: 40–90%)")

        # --- Insert: 5 % of the DiDiC map re-allocated by each insert method
        for method in ("random", "fewest_vertices", "least_traffic"):
            log = generate_dynamism(didic_parts, 0.05, method, k=k,
                                    vertex_traffic=results["didic"].per_vertex, seed=cfg.seed)
            svc.partition_with(apply_dynamism(didic_parts, log))
            res = svc.run_ops(ops)
            print(f"  insert/{method:15s} 5%: T_G%={res.percent_global*100:6.2f}% "
                  f"cv_traffic={metrics.coefficient_of_variation(res.per_partition)*100:5.1f}%")

        # --- Stress: 25 % random dynamism, repaired by one cold DiDiC iteration
        svc.partition_with(didic_parts.copy())
        svc.runtime.state = None
        stress = DynamicExperimentRuntime(svc, insert_method="random", seed=1).run(
            ops, n_slices=1, amount=0.25, maintain_every=1, measure_damaged=True)
        rec = stress.records[0]
        print(f"  stress: damaged T_G%={rec.damaged_percent_global*100:.2f} → repaired "
              f"{rec.percent_global*100:.2f} (one DiDiC iteration, {rec.migrated} migrated)")

        # --- Dynamic: 5 % slices of random inserts, maintained every slice
        svc = PartitionedGraphService(graph, k, didic=didic_cfg, device=args.device)
        svc.runtime.state = state
        svc.partition_with(didic_parts.copy())
        dynamic = DynamicExperimentRuntime(svc, insert_method="random", seed=cfg.seed).run(
            ops, n_slices=3, amount=0.05, maintain_every=1)
        print("  dynamic: T_G% per slice " + ", ".join(
            f"{r.percent_global*100:.2f} ({r.migrated} migrated)" for r in dynamic.records)
            + f"; start {dynamic.baseline.percent_global*100:.2f}")


if __name__ == "__main__":
    main()
