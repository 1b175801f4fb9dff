"""The paper's tables, one function per table or figure.

Twin of ``benchmarks/paper_tables.py`` and of the table part of
``benchmarks/run.py``. Every function returns
``name,value,derived`` rows with the JAX package's names, rounding and
``derived`` strings:

  table_7_1                 edge cut per dataset × method × k
  tables_7_2_to_7_4         load-balance CV (traffic / vertices / edges)
  static_traffic            Figs 7.1–7.3: T_G% per method + reduction vs random
  correlation_check         Eq. 7.3 predicted vs measured T_G%
  insert_experiment         §7.4: dynamism levels × insert methods
  insert_growth_experiment  §7.4 with write-time vertex allocation
  stress_experiment         §7.5: one DiDiC iteration repairs 25 % dynamism
  dynamic_experiment        §7.6: intermittent DiDiC under ongoing dynamism
  maintenance_cost          §Abstract: maintenance ≈ 1 % of initial partitioning

Replays and DiDiC run on ``device`` (``None`` means CUDA; GIS replays go
through ``frontier_gather``). The three static tables and the Insert
experiment replay the same (dataset, method, k) triples, so each replay is
computed once and cached in the bench; no row changes.

The Insert-growth, Stress and Dynamic tables take the JAX bench's ``mesh``
(a :class:`~repro_torch.launch.mesh.ReplayMesh` over an open process
group; every rank runs the same table) and, for Stress and Dynamic,
``maintenance``: on a mesh the service replays sharded and resident and
draws the sequential insert policies with the device scan, and its DiDiC
is the mesh DiDiC (``"auto"``, ``"sharded"``; seeded from the map, so the
initial diffusion state is not carried) or the single-device one
(``"shared"``, whose rows equal the meshless rows). A mesh run's
``cycle_s`` row says ``(resident device replay)``. The CLI runs meshless,
as ``benchmarks/run.py`` does.

    PYTHONPATH=src python -m repro_torch.paper_tables --scale 1.0 --tables 7.1,corr
    PYTHONPATH=src python -m repro_torch.paper_tables --device cpu --scale 0.002 --didic-iters 10

``--tables`` takes ``all`` or a comma list of ``7.1, 7.2, static, corr,
insert, insert-growth, stress, dynamic, maint``. The JAX CLI's ``kernels``
and ``roofline`` rows are TPU measurements with no twin; asking for them
exits non-zero (the port's kernel figures are in ``PERF.md`` §6).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.paper_didic import PaperExperimentConfig
from repro_torch.core import metrics, partitioners
from repro_torch.core.didic import didic_partition, didic_refine
from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
from repro_torch.core.dynamism import apply_dynamism, generate_dynamism
from repro_torch.core.framework import PartitionedGraphService
from repro_torch.core.traffic import TrafficResult, execute_ops, generate_ops
from repro_torch.graphs import datasets

__all__ = ["Row", "PaperBench", "TABLES", "row_names", "main"]

# ``--tables`` key -> table function, in the order ``all_tables`` runs them.
TABLES = {
    "7.1": "table_7_1",
    "7.2": "tables_7_2_to_7_4",
    "static": "static_traffic",
    "corr": "correlation_check",
    "insert": "insert_experiment",
    "insert-growth": "insert_growth_experiment",
    "stress": "stress_experiment",
    "dynamic": "dynamic_experiment",
    "maint": "maintenance_cost",
}
INSERT_METHODS = ("random", "fewest_vertices", "least_traffic")
GROWTH_RATES = (0.1, 0.3)
DYNAMIC_SLICES = 5


@dataclasses.dataclass
class Row:
    name: str
    value: float
    derived: str = ""

    def csv(self) -> str:
        return f"{self.name},{self.value},{self.derived}"


class PaperBench:
    """Caches graphs, op logs, partitionings and replays across the tables.

    ``_parts`` holds each partition map under ``(dataset, method, k)`` and
    DiDiC's diffusion state under ``(dataset, "didic_state", k)``, as the
    JAX package's bench does.
    """

    def __init__(self, cfg: Optional[PaperExperimentConfig] = None, device=None):
        self.cfg = cfg or PaperExperimentConfig()
        self.device = resolve_device(device)
        self._graphs = {}
        self._ops = {}
        self._parts = {}
        self._replays: Dict = {}

    # ------------------------------------------------------------- caching
    def graph(self, name: str):
        if name not in self._graphs:
            self._graphs[name] = datasets.load(name, scale=self.cfg.scale, seed=self.cfg.seed)
        return self._graphs[name]

    def ops(self, name: str):
        if name not in self._ops:
            n = self.cfg.n_ops_gis if name == "gis" else self.cfg.n_ops
            self._ops[name] = generate_ops(self.graph(name), n_ops=n, seed=self.cfg.seed)
        return self._ops[name]

    def partition(self, name: str, method: str, k: int) -> np.ndarray:
        key = (name, method, k)
        if key not in self._parts:
            g = self.graph(name)
            if method == "random":
                p = partitioners.random_partition(g.n_nodes, k, seed=self.cfg.seed)
            elif method == "didic":
                p, state = didic_partition(g, self.cfg.didic(name, k), seed=self.cfg.seed,
                                           device=self.device)
                self._parts[(name, "didic_state", k)] = state
            elif method == "hardcoded":
                p = partitioners.hardcoded_for(g, k)
                if p is None:
                    return None
            else:
                raise KeyError(method)
            self._parts[key] = p
        return self._parts[key]

    def replay(self, name: str, method: str, k: int) -> TrafficResult:
        """The dataset's log replayed on one of its static partitionings."""
        key = (name, method, k)
        if key not in self._replays:
            self._replays[key] = execute_ops(
                self.graph(name), self.ops(name), self.partition(name, method, k), k,
                device=self.device,
            )
        return self._replays[key]

    def methods_for(self, name: str) -> List[str]:
        return ["random", "didic"] + ([] if name == "twitter" else ["hardcoded"])

    # ------------------------------------------------------------- tables
    def table_7_1(self) -> List[Row]:
        rows = []
        for name in self.cfg.datasets:
            g = self.graph(name)
            for k in self.cfg.partition_counts:
                for method in self.methods_for(name):
                    p = self.partition(name, method, k)
                    ec = metrics.edge_cut_fraction(g, p)
                    rows.append(Row(f"table7.1/{name}/k{k}/{method}/edge_cut_pct", round(ec * 100, 2)))
        return rows

    def tables_7_2_to_7_4(self) -> List[Row]:
        rows = []
        for name in self.cfg.datasets:
            g = self.graph(name)
            for k in self.cfg.partition_counts:
                for method in self.methods_for(name):
                    p = self.partition(name, method, k)
                    res = self.replay(name, method, k)
                    counts = metrics.partition_counts(g, p, k)
                    for what, vals in (
                        ("traffic", res.per_partition),
                        ("vertices", counts["vertices"]),
                        ("edges", counts["edges"]),
                    ):
                        cv = metrics.coefficient_of_variation(vals)
                        rows.append(
                            Row(f"table7.2-4/{name}/k{k}/{method}/cv_{what}_pct", round(cv * 100, 2))
                        )
        return rows

    def static_traffic(self) -> List[Row]:
        rows = []
        for name in self.cfg.datasets:
            for k in self.cfg.partition_counts:
                base = None
                for method in self.methods_for(name):
                    pg = self.replay(name, method, k).percent_global
                    rows.append(Row(f"fig7.1-3/{name}/k{k}/{method}/percent_global", round(pg * 100, 3)))
                    if method == "random":
                        base = pg
                    else:
                        red = (1 - pg / base) * 100 if base else 0.0
                        rows.append(
                            Row(
                                f"fig7.1-3/{name}/k{k}/{method}/traffic_reduction_pct",
                                round(red, 1),
                                "paper: DiDiC 40-90% vs random",
                            )
                        )
        return rows

    def correlation_check(self) -> List[Row]:
        rows = []
        for name in self.cfg.datasets:
            g = self.graph(name)
            ops = self.ops(name)
            for k in self.cfg.partition_counts:
                p = self.partition(name, "random", k)
                ec = metrics.edge_cut_fraction(g, p)
                measured = self.replay(name, "random", k).percent_global
                predicted = metrics.expected_global_traffic(ops.t_pg, ops.t_l, ec)
                rows.append(Row(f"eq7.3/{name}/k{k}/measured", round(measured * 100, 3)))
                rows.append(Row(f"eq7.3/{name}/k{k}/predicted", round(predicted * 100, 3)))
                rel = abs(measured - predicted) / max(predicted, 1e-9)
                rows.append(Row(f"eq7.3/{name}/k{k}/rel_error", round(rel, 4), "paper: close match"))
        return rows

    def insert_experiment(self, k: int = 4) -> List[Row]:
        rows = []
        for name in self.cfg.datasets:
            g = self.graph(name)
            ops = self.ops(name)
            base = self.partition(name, "didic", k)
            base_res = self.replay(name, "didic", k)
            for method in INSERT_METHODS:
                for level in self.cfg.dynamism_levels:
                    log = generate_dynamism(
                        base, level, method, k=k,
                        vertex_traffic=base_res.per_vertex, seed=self.cfg.seed,
                    )
                    p2 = apply_dynamism(base, log)
                    res = execute_ops(g, ops, p2, k, device=self.device)
                    rows.append(
                        Row(
                            f"insert/{name}/{method}/dyn{int(level*100)}/percent_global",
                            round(res.percent_global * 100, 3),
                        )
                    )
                    rows.append(
                        Row(
                            f"insert/{name}/{method}/dyn{int(level*100)}/cv_traffic_pct",
                            round(metrics.coefficient_of_variation(res.per_partition) * 100, 2),
                        )
                    )
        return rows

    def insert_growth_experiment(self, k: int = 4, mesh=None, n_slices: int = 4,
                                 amount: float = 0.05) -> List[Row]:
        """§7.4's Insert experiment with write-time vertex allocation: per
        insert policy and insert rate, ``n_slices`` slices of ``amount``
        dynamism in which ``rate`` of the units allocate a new vertex with
        its edges, DiDiC maintaining every second slice (on a ``mesh``, the
        mesh DiDiC). Rows record the final T_G%, the served-traffic balance
        CV and the vertex growth."""
        rows = []
        for name in self.cfg.datasets:
            g = self.graph(name)
            for method in INSERT_METHODS:
                for rate in GROWTH_RATES:
                    runtime = self._runtime_for(name, k, method, mesh=mesh)
                    res = runtime.run(
                        self.ops(name), n_slices=n_slices, amount=amount,
                        maintain_every=2, insert_rate=rate,
                    )
                    grown = runtime.service.graph.n_nodes - g.n_nodes
                    tag = f"insert_growth/{name}/{method}/rate{int(rate * 100)}"
                    rows.append(Row(
                        f"{tag}/percent_global",
                        round(res.final.percent_global * 100, 3),
                        "paper: repartitioning holds quality under inserts",
                    ))
                    rows.append(Row(
                        f"{tag}/cv_traffic_pct",
                        round(metrics.coefficient_of_variation(
                            res.final.per_partition) * 100, 2),
                    ))
                    rows.append(Row(f"{tag}/grown_vertices", grown))
        return rows

    def _runtime_for(self, name: str, k: int, insert_method: str, mesh=None,
                     maintenance: str = "auto",
                     carry_state: bool = True) -> DynamicExperimentRuntime:
        """Service + runtime on the cached DiDiC partitioning, on ``mesh``
        when one is given (``maintenance`` picks its DiDiC). ``carry_state``
        seeds maintenance from the initial partitioning's diffusion state
        (the Dynamic experiment's warm maintenance) unless the mesh DiDiC
        maintains, which seeds from the map; the Stress experiment measures
        the paper's cold one-iteration repair and passes ``False``."""
        g = self.graph(name)
        parts = self.partition(name, "didic", k)  # also fills the state cache
        svc = PartitionedGraphService(g, k, didic=self.cfg.didic(name, k), device=self.device,
                                      mesh=mesh, maintenance=maintenance)
        if carry_state and (mesh is None or maintenance == "shared"):
            svc.runtime.state = self._parts.get((name, "didic_state", k))
        svc.partition_with(parts.copy())
        return DynamicExperimentRuntime(svc, insert_method=insert_method, seed=self.cfg.seed)

    def stress_experiment(self, k: int = 4, mesh=None, maintenance: str = "auto") -> List[Row]:
        """§7.5. On a ``mesh``, ``maintenance="shared"`` keeps the
        single-device DiDiC (rows equal to the meshless ones) while replay
        and dynamism run on the mesh; ``"auto"`` runs the mesh DiDiC."""
        rows = []
        for name in self.cfg.datasets:
            runtime = self._runtime_for(name, k, "random", mesh=mesh, maintenance=maintenance,
                                        carry_state=False)
            res = runtime.run(self.ops(name), n_slices=1, amount=0.25,
                              maintain_every=1, measure_damaged=True)
            rec = res.records[0]
            rows += [
                Row(f"stress/{name}/base_pg", round(res.baseline.percent_global * 100, 3)),
                Row(f"stress/{name}/damaged_pg", round(rec.damaged_percent_global * 100, 3)),
                Row(f"stress/{name}/repaired_pg", round(rec.percent_global * 100, 3),
                    "paper: 1 iteration repairs 25% dynamism"),
            ]
        return rows

    def dynamic_experiment(self, k: int = 4, mesh=None, insert_method: str = "random",
                           maintenance: str = "auto") -> List[Row]:
        """§7.6; ``mesh`` and ``maintenance`` as in :meth:`stress_experiment`."""
        rows = []
        for name in self.cfg.datasets:
            runtime = self._runtime_for(name, k, insert_method, mesh=mesh,
                                        maintenance=maintenance)
            t0 = time.perf_counter()
            res = runtime.run(self.ops(name), n_slices=DYNAMIC_SLICES, amount=0.05,
                              maintain_every=1)
            cycle_s = time.perf_counter() - t0
            for rec in res.records:
                rows.append(Row(
                    f"dynamic/{name}/round{rec.index+1}/percent_global",
                    round(rec.percent_global * 100, 3),
                    "paper: quality maintained under ongoing dynamism",
                ))
                rows.append(Row(
                    f"dynamic/{name}/round{rec.index+1}/migrated_vertices",
                    rec.migrated,
                ))
            rows.append(Row(f"dynamic/{name}/cycle_s", round(cycle_s, 2),
                            "5 slices incl. baseline replay"
                            + (" (resident device replay)" if mesh is not None else "")))
        return rows

    def maintenance_cost(self, k: int = 4) -> List[Row]:
        """Wall-clock ratio of 1 maintenance iteration vs the initial T=100.

        One refine on a random map runs first, so that the DiDiC products
        are built and cached before either timing, and the ratio compares
        computation, as the paper does."""
        rows = []
        for name in self.cfg.datasets:
            g = self.graph(name)
            cfg = self.cfg.didic(name, k)
            didic_refine(
                g, partitioners.random_partition(g.n_nodes, k, self.cfg.seed),
                cfg, iterations=1, device=self.device,
            )
            t0 = time.perf_counter()
            parts, state = didic_partition(g, cfg, seed=self.cfg.seed, device=self.device)
            t_init = time.perf_counter() - t0
            t0 = time.perf_counter()
            didic_refine(g, parts, cfg, state=state, iterations=1, device=self.device)
            t_one = time.perf_counter() - t0
            ratio = t_one / max(t_init, 1e-9)
            rows.append(Row(f"maintenance/{name}/cost_ratio_pct", round(ratio * 100, 2),
                            "paper: ~1% of initial partitioning"))
        return rows

    def tables(self) -> Dict[str, Callable[[], List[Row]]]:
        """The table functions under their ``--tables`` keys, in the order
        :meth:`all_tables` runs them."""
        return {key: getattr(self, fn) for key, fn in TABLES.items()}

    def all_tables(self) -> List[Row]:
        rows = []
        for fn in self.tables().values():
            t0 = time.perf_counter()
            rows += fn()
            rows.append(Row(f"_timing/{fn.__name__}_s", round(time.perf_counter() - t0, 1)))
        return rows


def row_names(cfg: PaperExperimentConfig, table: str) -> List[str]:
    """The row names the table function under ``--tables`` key ``table``
    emits under ``cfg``, in order."""
    names = []
    for ds in cfg.datasets:
        methods = ["random", "didic"] + ([] if ds == "twitter" else ["hardcoded"])
        if table == "7.1":
            names += [f"table7.1/{ds}/k{kk}/{m}/edge_cut_pct"
                      for kk in cfg.partition_counts for m in methods]
        elif table == "7.2":
            names += [f"table7.2-4/{ds}/k{kk}/{m}/cv_{w}_pct" for kk in cfg.partition_counts
                      for m in methods for w in ("traffic", "vertices", "edges")]
        elif table == "static":
            for kk in cfg.partition_counts:
                for m in methods:
                    names.append(f"fig7.1-3/{ds}/k{kk}/{m}/percent_global")
                    if m != "random":
                        names.append(f"fig7.1-3/{ds}/k{kk}/{m}/traffic_reduction_pct")
        elif table == "corr":
            names += [f"eq7.3/{ds}/k{kk}/{w}" for kk in cfg.partition_counts
                      for w in ("measured", "predicted", "rel_error")]
        elif table == "insert":
            names += [f"insert/{ds}/{m}/dyn{int(lv*100)}/{w}" for m in INSERT_METHODS
                      for lv in cfg.dynamism_levels for w in ("percent_global", "cv_traffic_pct")]
        elif table == "insert-growth":
            names += [f"insert_growth/{ds}/{m}/rate{int(r * 100)}/{w}"
                      for m in INSERT_METHODS for r in GROWTH_RATES
                      for w in ("percent_global", "cv_traffic_pct", "grown_vertices")]
        elif table == "stress":
            names += [f"stress/{ds}/{w}" for w in ("base_pg", "damaged_pg", "repaired_pg")]
        elif table == "dynamic":
            names += [f"dynamic/{ds}/round{i+1}/{w}" for i in range(DYNAMIC_SLICES)
                      for w in ("percent_global", "migrated_vertices")]
            names.append(f"dynamic/{ds}/cycle_s")
        elif table == "maint":
            names.append(f"maintenance/{ds}/cost_ratio_pct")
        else:
            raise KeyError(table)
    return names


_TPU_ONLY = ("kernels", "roofline")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.01,
                    help="fraction of paper dataset sizes (1.0 = paper)")
    ap.add_argument("--tables", type=str, default="all",
                    help="all, or a comma list: " + ",".join(TABLES))
    ap.add_argument("--didic-iters", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    want = args.tables.split(",")
    tpu = [key for key in want if key in _TPU_ONLY]
    if tpu:
        ap.error(f"--tables {','.join(tpu)}: TPU rows with no twin in the port; "
                 "its kernel figures are in PERF.md §6")
    unknown = [key for key in want if key != "all" and key not in TABLES]
    if unknown:
        ap.error(f"unknown tables {unknown}; choose from all,{','.join(TABLES)}")

    cfg = PaperExperimentConfig(scale=args.scale, didic_iterations=args.didic_iters)
    bench = PaperBench(cfg, device=args.device)
    t0 = time.perf_counter()
    print("name,value,derived", flush=True)
    if "all" in want:
        for r in bench.all_tables():
            print(r.csv())
    else:
        tables = bench.tables()
        for key in want:
            for r in tables[key]():
                print(r.csv(), flush=True)
    print(f"_total_wall_s,{time.perf_counter() - t0:.1f},")


if __name__ == "__main__":
    main()
