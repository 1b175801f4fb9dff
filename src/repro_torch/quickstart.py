"""Quickstart: partition a graph database with DiDiC and measure the
paper's metrics (edge cut, inter-partition traffic, load balance).

Twin of ``examples/quickstart.py``, on the port:

    PYTHONPATH=src python -m repro_torch.quickstart                 # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu --scale 0.002
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import metrics, partitioners
from repro_torch.core.didic import DidicConfig, didic_partition
from repro_torch.core.framework import PartitionedGraphService
from repro_torch.graphs import datasets


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dataset", default="twitter", choices=("filesystem", "gis", "twitter"))
    ap.add_argument("--scale", type=float, default=0.01)
    args = ap.parse_args(argv)

    # 1. Load a graph dataset (default: synthetic Twitter crawl, ~6k users).
    graph = datasets.load(args.dataset, scale=args.scale)
    print(graph.summary())

    # 2. Partition it: random baseline vs the paper's DiDiC algorithm.
    k = 4
    random_parts = partitioners.random_partition(graph.n_nodes, k, seed=0)
    didic_parts, _ = didic_partition(
        graph, DidicConfig(k=k, iterations=60), seed=0, device=args.device
    )

    # 3. Execute the dataset's access pattern on both and compare.
    svc = PartitionedGraphService(graph, k, device=args.device)
    ops = svc.make_ops(n_ops=2000, seed=0)

    for name, parts in (("random", random_parts), ("didic", didic_parts)):
        svc.partition_with(parts)
        result = svc.run_ops(ops)
        report = svc.report()
        print(
            f"{name:>7}: edge_cut={report['edge_cut_fraction']*100:5.1f}%  "
            f"T_G%={result.percent_global*100:5.2f}%  "
            f"modularity={report['modularity']:+.3f}  "
            f"cv_traffic={metrics.coefficient_of_variation(result.per_partition)*100:5.1f}%"
        )

    print("\nDiDiC should cut inter-partition traffic by ≥40% vs random (paper §7.3.3).")


if __name__ == "__main__":
    main()
