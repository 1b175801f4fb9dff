"""Skew-aware placement smoke: the hot-vertex exception table against skew.

Twin of ``skew_smoke`` in ``benchmarks/kernel_bench.py``, on one device.
Sweeps the exception table over 0/8/32/128 replicated vertices on a DiDiC
partitioning (k = 8, 25 iterations) of two workloads: Twitter's pattern,
where hub reads dominate, and filesystem's, the uniform control. At each
capacity the hot set is chosen from the baseline replay's per-vertex
traffic by ``select_hot_vertices``, the signal the service's
``refresh_placement`` uses. Gates, each fatal:

* **parity**: the scalar oracle and the batched engine agree on all four
  counters at every capacity (replica routing is host-side in both);
* **empty table**: capacity 0 equals the replay with no mask;
* **skew win**: Twitter's global traffic falls by at least 20 % at 128
  replicated vertices;
* **uniform control**: filesystem's global traffic never rises by more
  than 1 % at any capacity.

The JAX smoke also holds the sharded engine and counts XLA compiles during
the sweep. The sharded engine needs a process group, which this one-process
smoke does not open (``tests/test_torch_sharded.py`` holds it, replicas
included through ``cross_degree``); eager PyTorch compiles nothing, so that
gate has no twin here.

    PYTHONPATH=src python -m repro_torch.skew_smoke                    # on the card
    PYTHONPATH=src python -m repro_torch.skew_smoke --device cpu --scale 0.01 --n-ops 48
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.didic import DidicConfig, didic_partition
from repro_torch.core.partitioners import select_hot_vertices
from repro_torch.core.traffic import execute_ops, generate_ops
from repro_torch.graphs import datasets

__all__ = ["CAPACITIES", "K", "DIDIC_ITERATIONS", "hot_mask", "skew_smoke", "main"]

CAPACITIES = (0, 8, 32, 128)
K = 8
DIDIC_ITERATIONS = 25
WORKLOADS = (("twitter", "twitter"), ("filesystem", "filesystem"))
FIELDS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")


def hot_mask(per_vertex: np.ndarray, capacity: int) -> Optional[np.ndarray]:
    """The bool[N] replica mask of the top-``capacity`` vertices by traffic,
    or ``None`` when none is chosen."""
    hot = select_hot_vertices(per_vertex, capacity)
    if not hot.size:
        return None
    mask = np.zeros(per_vertex.shape[0], dtype=bool)
    mask[hot] = True
    return mask


def _cv(per_partition: np.ndarray) -> float:
    per_partition = np.asarray(per_partition, dtype=np.float64)
    mean = per_partition.mean()
    return float(per_partition.std() / mean) if mean else 0.0


def skew_smoke(scale: Optional[float] = None, n_ops: int = 96, device=None,
               parts: Optional[Dict[str, np.ndarray]] = None) -> Tuple[List[str], Dict]:
    """Run the sweep and its gates; returns ``(rows, update)``, ``update``
    shaped like the JAX package's ``skew`` section. ``parts`` maps a dataset
    to a partitioning to use instead of the DiDiC run."""
    dev = resolve_device(device)
    scale = 0.05 if scale is None else scale
    rows: List[str] = []
    update: Dict[str, Dict] = {}
    for name, pattern in WORKLOADS:
        g = datasets.load(name, scale=scale, seed=0)
        if parts is not None and name in parts:
            p = np.asarray(parts[name], dtype=np.int32)
        else:
            p, _ = didic_partition(g, DidicConfig(k=K, iterations=DIDIC_ITERATIONS), seed=0,
                                   device=dev)
            p = np.asarray(p, dtype=np.int32)
        ops = generate_ops(g, n_ops=n_ops, seed=2, pattern=pattern)
        base = execute_ops(g, ops, p, K, engine="batched", device=dev)

        sweep = {}
        for capacity in CAPACITIES:
            replicated = hot_mask(base.per_vertex, capacity)
            sc = execute_ops(g, ops, p, K, engine="scalar", replicated=replicated)
            bt = execute_ops(g, ops, p, K, engine="batched", device=dev, replicated=replicated)
            for f in FIELDS:
                if not np.array_equal(getattr(sc, f), getattr(bt, f)):
                    raise AssertionError(f"{name}/cap{capacity}: scalar != batched on {f}")
            if capacity == 0:
                for f in FIELDS:
                    if not np.array_equal(getattr(bt, f), getattr(base, f)):
                        raise AssertionError(
                            f"{name}: the empty exception table differs from the "
                            f"replay with no mask ({f})")
            sweep[capacity] = {
                "replicated": 0 if replicated is None else int(replicated.sum()),
                "global_traffic": float(bt.per_op_global.sum()),
                "load_cv": round(_cv(bt.per_partition), 4),
            }

        g0 = sweep[0]["global_traffic"]
        g128 = sweep[128]["global_traffic"]
        reduction = (g0 - g128) / g0 if g0 else 0.0
        if name == "twitter" and reduction < 0.20:
            raise AssertionError(
                f"twitter: {reduction:.1%} global-traffic reduction at 128 "
                "replicas; need >= 20% vs pure DiDiC")
        worst = max(s["global_traffic"] for s in sweep.values())
        if worst > g0 * 1.01:
            raise AssertionError(
                f"{name}: global traffic rose {worst / g0 - 1:.2%} under "
                "replication; must stay <= +1%")
        update[name] = {
            "scale": scale, "n_ops": n_ops, "k": K,
            "didic_iterations": DIDIC_ITERATIONS,
            "sweep": {str(c): sweep[c] for c in CAPACITIES},
            "reduction_at_128": round(reduction, 4),
        }
        rows.append(
            f"skew/{name}/reduction_at_128,{reduction:.3f},"
            f"global {g0:.0f} -> {g128:.0f} over capacities "
            f"{list(CAPACITIES)} (load CV {sweep[0]['load_cv']:.3f} -> "
            f"{sweep[128]['load_cv']:.3f}, scalar == batched at every capacity)"
        )
    return rows, update


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--n-ops", type=int, default=96)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rows, update = skew_smoke(scale=args.scale, n_ops=args.n_ops, device=args.device)
    for row in rows:
        print(row)
    print(json.dumps({"skew": update}, sort_keys=True))


if __name__ == "__main__":
    main()
