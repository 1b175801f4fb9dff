"""Dynamism generation and insert-partitioning methods (paper §6.4).

Twin of ``repro.core.dynamism``, draw for draw: the same seed gives the
same log, and :meth:`DynamismLog.fingerprint` the same hash. A
:class:`DynamismLog` is a replayable sequence of units, each either

* a **partition move** — an existing vertex is re-assigned to a partition
  chosen by an insert-partitioning method (``dynamism = units / |V|``,
  Eq. 6.1), or
* a **vertex insert** — a *new* vertex (plus its incident edges and
  metadata) is allocated to a partition by the same method, as the paper's
  Insert-Partitioning component allocates entities at write time.

Insert methods (paper §6.4): ``random`` (uniform target), ``fewest_vertices``
(the partition with fewest vertices) and ``least_traffic`` (the partition
with least accumulated traffic). Units are generated sequentially: each
choice sees the counts updated by every earlier unit, as in the paper's
simulator. Structural logs carry per-unit attribution of their inserts, so
:meth:`DynamismLog.slice` cuts them into the Dynamic experiment's 5 %
slices without dropping or repeating an insert.

The JAX package can also run the sequential policies as one device scan
(``engine="device"``), which it takes only on a mesh; here that scan
raises until the multi-device slice of the port brings it (``random``
needs no scan and draws on the host under either engine, as there).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np

from repro_torch.graphs.generators import FS_FILE, FS_FOLDER

__all__ = ["DynamismLog", "generate_dynamism", "apply_dynamism", "INSERT_METHODS"]

INSERT_METHODS = ("random", "fewest_vertices", "least_traffic")


@dataclasses.dataclass
class DynamismLog:
    vertices: np.ndarray   # [units] vertex moved (move) or allocated (insert)
    targets: np.ndarray    # [units] destination partition
    method: str
    k: int
    # Structural inserts: edges written during the slice.
    insert_senders: Optional[np.ndarray] = None    # [inserts] int
    insert_receivers: Optional[np.ndarray] = None  # [inserts] int
    insert_weights: Optional[np.ndarray] = None    # [inserts] float32
    # Vertex growth: units flagged in ``unit_is_insert`` allocate a new
    # vertex (its id in ``vertices``, contiguous from ``base_nodes``);
    # ``insert_unit[e]`` is the unit that wrote edge ``e``, and
    # ``insert_attrs`` holds one metadata row per new vertex in allocation
    # order (coordinates for GIS, type/parent/depth for filesystem trees).
    base_nodes: Optional[int] = None               # |V| before this log
    unit_is_insert: Optional[np.ndarray] = None    # [units] bool
    insert_unit: Optional[np.ndarray] = None       # [inserts] int64, -1 = unattributed
    insert_attrs: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def units(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def n_new_vertices(self) -> int:
        """New vertices this log allocates (0 for pure-move logs)."""
        if self.unit_is_insert is None:
            return 0
        return int(np.asarray(self.unit_is_insert).sum())

    @property
    def structural(self) -> bool:
        """True when the log changes graph structure (edges or vertices)."""
        has_edges = (
            self.insert_senders is not None
            and np.asarray(self.insert_senders).shape[0] > 0
        )
        return has_edges or self.n_new_vertices > 0

    @property
    def _unit_attributed(self) -> bool:
        """Structural payload carries per-unit attribution (sliceable)."""
        return (
            self.base_nodes is not None
            and self.unit_is_insert is not None
            and self.insert_unit is not None
        )

    def fingerprint(self) -> str:
        """Content hash over every semantic field, presence-tagged so that
        ``None`` and empty never collide; equal to the JAX package's for an
        equal log. Cached: logs are immutable once generated."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.sha1()
            h.update(f"{self.method}|{self.k}|{self.base_nodes}".encode())
            for name in ("vertices", "targets", "insert_senders",
                         "insert_receivers", "insert_weights", "unit_is_insert",
                         "insert_unit"):
                arr = getattr(self, name)
                h.update(b"\x00" if arr is None else b"\x01")
                if arr is not None:
                    a = np.ascontiguousarray(arr)
                    h.update(str(a.dtype).encode())
                    h.update(a.tobytes())
            for key in sorted(self.insert_attrs):
                a = np.ascontiguousarray(self.insert_attrs[key])
                h.update(key.encode() + str(a.dtype).encode())
                h.update(a.tobytes())
            fp = self.__dict__["_fingerprint"] = h.hexdigest()
        return fp

    def new_vertices(self) -> np.ndarray:
        """Ids of the vertices this log allocates, in allocation order."""
        if self.unit_is_insert is None:
            return np.zeros(0, dtype=np.int64)
        return np.asarray(self.vertices, dtype=np.int64)[
            np.asarray(self.unit_is_insert, dtype=bool)
        ]

    def dirty_vertices(self) -> np.ndarray:
        """Vertices whose graph structure this log changes: the new vertices
        and the endpoints of the inserted edges (moves change none)."""
        if not self.structural:
            return np.zeros(0, dtype=np.int64)
        parts = [self.new_vertices()]
        if self.insert_senders is not None:
            parts += [
                np.asarray(self.insert_senders, dtype=np.int64),
                np.asarray(self.insert_receivers, dtype=np.int64),
            ]
        return np.unique(np.concatenate(parts))

    def _endpoint(self, frac: float) -> int:
        """Map a fraction to a unit index so that equal rationals map to
        equal indices however the caller computed the float (round half up
        with an epsilon that absorbs ~1 ulp of noise)."""
        return min(self.units, max(0, int(np.floor(self.units * frac + 0.5 + 1e-9))))

    def slice(self, start_frac: float, stop_frac: float) -> "DynamismLog":
        """Sub-log for ``[start_frac, stop_frac)`` of the units.

        Consecutive slices partition the log exactly. A structural log
        slices when its inserts carry per-unit attribution (the generator's
        always do): each slice keeps the edges and new-vertex rows its units
        wrote, and its ``base_nodes`` advances past earlier slices' inserts,
        so the slices applied in sequence equal the whole log.
        """
        if self.structural and not self._unit_attributed:
            raise ValueError(
                "structural dynamism log has no per-unit insert attribution "
                "and cannot be sub-sliced"
            )
        lo = self._endpoint(start_frac)
        hi = self._endpoint(stop_frac)
        if not self.structural and self.unit_is_insert is None:
            return DynamismLog(
                self.vertices[lo:hi], self.targets[lo:hi], self.method, self.k
            )
        ins = np.asarray(self.unit_is_insert, dtype=bool)
        unit_of_edge = np.asarray(self.insert_unit, dtype=np.int64)
        sel = (unit_of_edge >= lo) & (unit_of_edge < hi)
        first_new = int(ins[:lo].sum())
        n_new = int(ins[lo:hi].sum())
        return DynamismLog(
            vertices=self.vertices[lo:hi],
            targets=self.targets[lo:hi],
            method=self.method,
            k=self.k,
            insert_senders=np.asarray(self.insert_senders)[sel],
            insert_receivers=np.asarray(self.insert_receivers)[sel],
            insert_weights=(
                None if self.insert_weights is None
                else np.asarray(self.insert_weights)[sel]
            ),
            base_nodes=int(self.base_nodes) + first_new,
            unit_is_insert=ins[lo:hi],
            insert_unit=unit_of_edge[sel] - lo,
            insert_attrs={
                key: rows[first_new: first_new + n_new]
                for key, rows in self.insert_attrs.items()
            },
        )


def _grow_payload(graph, anchors: np.ndarray, new_ids: np.ndarray, rng):
    """Structural payload for one new vertex per anchor, drawn from ``rng``
    independently of the targets. Flavours:

    * coordinate graphs (GIS): the new vertex lands a small offset from its
      anchor, one edge new→anchor with weight above the Euclidean length
      (the A* admissibility the replay relies on);
    * filesystem trees: a file under the anchor's nearest enclosing folder
      (edge folder→file);
    * everything else (Twitter): a follow edge each way, unit-major, so
      that slices concatenate to the whole log's edge order.

    Returns ``(senders, receivers, weights, attrs)``, attrs rows in
    ``new_ids`` order.
    """
    attrs = graph.node_attrs
    n_ins = anchors.shape[0]
    if "lon" in attrs and "lat" in attrs:
        lon = np.asarray(attrs["lon"], dtype=np.float64)
        lat = np.asarray(attrs["lat"], dtype=np.float64)
        off = rng.normal(0.0, 0.01, size=(n_ins, 2))
        new_lon = lon[anchors] + off[:, 0]
        new_lat = lat[anchors] + off[:, 1]
        # Strictly above the straight-line length, with margin far beyond
        # float32 storage rounding of the coordinates.
        w = (np.hypot(off[:, 0], off[:, 1]) * 1.001 + 1e-5).astype(np.float32)
        return (
            new_ids.copy(), anchors.copy(), w,
            {"lon": new_lon.astype(attrs["lon"].dtype),
             "lat": new_lat.astype(attrs["lat"].dtype)},
        )
    if "node_type" in attrs:
        nt = np.asarray(attrs["node_type"])
        parent = np.asarray(attrs["parent"], dtype=np.int64)
        depth = np.asarray(attrs["depth"], dtype=np.int64)
        folder = anchors.astype(np.int64).copy()
        for _ in range(int(depth.max()) + 2):
            step = (nt[folder] != FS_FOLDER) & (parent[folder] >= 0)
            if not step.any():
                break
            folder[step] = parent[folder[step]]
        return (
            folder.copy(), new_ids.copy(),
            np.ones(n_ins, dtype=np.float32),
            {"node_type": np.full(n_ins, FS_FILE, dtype=nt.dtype),
             "parent": folder.astype(attrs["parent"].dtype),
             "depth": (depth[folder] + 1).astype(attrs["depth"].dtype)},
        )
    return (
        np.stack([anchors, new_ids], axis=1).reshape(-1),
        np.stack([new_ids, anchors], axis=1).reshape(-1),
        np.ones(2 * n_ins, dtype=np.float32),
        {},
    )


def generate_dynamism(
    parts: np.ndarray,
    amount: float,
    method: str = "random",
    k: Optional[int] = None,
    vertex_traffic: Optional[np.ndarray] = None,
    seed: "int | np.random.SeedSequence" = 0,
    engine: str = "host",
    insert_rate: float = 0.0,
    graph=None,
) -> DynamismLog:
    """Create ``amount·|V|`` sequential move/insert operations.

    ``vertex_traffic`` (required for ``least_traffic``) is the per-vertex
    traffic of a prior replay (``TrafficResult.per_vertex``); it may be
    shorter than ``parts`` (vertices grown since carry zero) and is
    zero-padded. Partition totals are float64 sums of it, updated as
    vertices move, exactly as in the JAX package, so ties break alike.

    ``insert_rate`` is the fraction of units that allocate a new vertex
    instead of moving one; it needs ``graph``, whose metadata seeds the new
    vertices' attributes and edges. With ``insert_rate=0`` the draws, and so
    the log, are those of a pure-move generator. ``seed`` may be a
    :class:`np.random.SeedSequence` (the insert partitioner's spawned
    streams). ``engine="device"`` with a sequential method is the
    multi-device slice's and raises.
    """
    if method not in INSERT_METHODS:
        raise ValueError(f"unknown insert method {method!r}")
    if engine not in ("host", "device"):
        raise ValueError(f"unknown dynamism engine {engine!r}")
    if engine == "device" and method != "random":
        raise NotImplementedError(
            "engine='device' (the JAX package's mesh scan of the insert policies) "
            "comes with the port's multi-device slice; use engine='host'"
        )
    if not 0.0 <= insert_rate <= 1.0:
        raise ValueError(f"insert_rate must be in [0, 1], got {insert_rate}")
    k = int(parts.max()) + 1 if k is None else k
    n = parts.shape[0]
    units = int(round(amount * n))
    rng = np.random.default_rng(seed)
    movers = rng.integers(0, n, size=units)

    if insert_rate > 0.0:
        if graph is None:
            raise ValueError("insert_rate > 0 requires the graph")
        if graph.n_nodes != n:
            raise ValueError(
                f"graph has {graph.n_nodes} vertices but parts has {n}"
            )
        is_insert = rng.random(units) < insert_rate
        n_ins = int(is_insert.sum())
        new_ids = n + np.arange(n_ins, dtype=np.int64)
        anchors = movers[is_insert].astype(np.int64)
        ins_s, ins_r, ins_w, ins_attrs = _grow_payload(graph, anchors, new_ids, rng)
        # Payloads are unit-major, so the per-edge attribution is a repeat.
        unit_ids = np.nonzero(is_insert)[0].astype(np.int64)
        reps = ins_s.shape[0] // max(n_ins, 1) if n_ins else 0
        insert_unit = np.repeat(unit_ids, reps) if n_ins else np.zeros(0, np.int64)
        vertices = movers.astype(np.int64)
        vertices[is_insert] = new_ids
        growth = dict(
            insert_senders=ins_s.astype(np.int64),
            insert_receivers=ins_r.astype(np.int64),
            insert_weights=ins_w,
            base_nodes=n,
            unit_is_insert=is_insert,
            insert_unit=insert_unit,
            insert_attrs=ins_attrs,
        )
    else:
        is_insert = None
        vertices = movers.astype(np.int64)
        growth = {}

    if vertex_traffic is not None and np.asarray(vertex_traffic).shape[0] < n:
        vertex_traffic = np.concatenate([
            np.asarray(vertex_traffic),
            np.zeros(n - np.asarray(vertex_traffic).shape[0],
                     dtype=np.asarray(vertex_traffic).dtype),
        ])

    cur = parts.astype(np.int64).copy()
    counts = np.bincount(cur, minlength=k).astype(np.int64)
    if method == "least_traffic":
        if vertex_traffic is None:
            raise ValueError("least_traffic requires vertex_traffic")
        traffic = np.zeros(k, dtype=np.float64)
        np.add.at(traffic, cur, vertex_traffic)
    targets = np.empty(units, dtype=np.int32)
    ins = np.zeros(units, dtype=bool) if is_insert is None else is_insert

    if method == "random":
        # Targets do not depend on the running counts: one vectorised draw
        # gives the same log as the sequential loop.
        targets[:] = rng.integers(0, k, size=units)
    elif method == "fewest_vertices":
        for i, v in enumerate(movers):
            t = int(np.argmin(counts))
            targets[i] = t
            if ins[i]:
                counts[t] += 1  # new vertex: no source to decrement
            else:
                counts[cur[v]] -= 1
                counts[t] += 1
                cur[v] = t
    else:  # least_traffic
        vt = np.asarray(vertex_traffic, dtype=np.float64)
        for i, v in enumerate(movers):
            t = int(np.argmin(traffic))
            targets[i] = t
            if ins[i]:
                counts[t] += 1  # new vertex: no observed traffic yet
            else:
                traffic[cur[v]] -= vt[v]
                traffic[t] += vt[v]
                counts[cur[v]] -= 1
                counts[t] += 1
                cur[v] = t

    return DynamismLog(vertices=vertices, targets=targets, method=method, k=k, **growth)


def apply_dynamism(parts: np.ndarray, log: DynamismLog) -> np.ndarray:
    """Replay a dynamism log onto a partition map (last write wins).
    Vertex-growth logs extend the map: new vertices take the partition the
    log allocated them."""
    n_new = log.n_new_vertices
    if n_new:
        if log.base_nodes is not None and parts.shape[0] != log.base_nodes:
            raise ValueError(
                f"partition map has {parts.shape[0]} vertices but the log "
                f"grows a base of {log.base_nodes}"
            )
        out = np.concatenate([parts, np.zeros(n_new, dtype=parts.dtype)])
    else:
        out = parts.copy()
    out[log.vertices] = log.targets
    return out
