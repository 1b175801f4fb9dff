"""DiDiC over a process group — the thesis's Future Work (§8.2) (twin of
``repro.core.didic_distributed``).

    "…the implementation of these algorithms in a truly distributed
     environment — rather than in a simulator."

DiDiC's inner loops are products with the Metropolis-scaled adjacency
(:mod:`repro_torch.core.didic`). Here each rank of a
:class:`~repro_torch.launch.mesh.ReplayMesh` owns one block of vertices
(:func:`~repro_torch.distributed.placement.build_layout` of a linear
bootstrap partition) and the product runs through the halo exchange of
:mod:`repro_torch.distributed.halo`: diffusion loads cross ranks only as
boundary rows. The iteration is the single-device step with its two global
reductions (the rescale's mean, the balance fit's sizes) summed over the
ranks; the commit mask is drawn over every row from the seed on every
rank, and each rank keeps its block.

* :func:`didic_partition_distributed` — initial partitioning from a random
  start (the Static experiment);
* :func:`didic_refine_distributed` — the maintenance pass (deterministic
  commit, full smoothing width, as :func:`~repro_torch.core.didic.didic_refine`),
  with the diffusion state carried sharded between calls and the pinned
  vertices restored on the host.

Both run the single-device arithmetic summed in another order (each
rank's halo product plus the collectives against one reduction over the
whole graph), so they match the single-device DiDiC in quality, not bit for
bit. Each order is fixed all the same: the halo product sums through the
port's fixed-order ``segment_sum`` (on the card its kernel), so a mesh
DiDiC run repeats bit for bit, and a retried maintenance pass is
bit-identical.

A store-backed graph (the delta-overlay growth path) is refined through a
**capacity mesh program** (:class:`_CapacityMeshProgram`), cached on the
store per (mesh, axes): its layout places the store's whole capacity
(``n_cap`` rows) linearly over the ranks once, so the carried state keeps
its shape across growth, and each grown graph is adopted into it by
rebuilding the halo tables host-side. The iteration is the overlay step of
:mod:`repro_torch.core.didic` (live-masked seeds, mean, balance sizes and
commit) on the halo product, with the same fixed number of collectives a
pass as the storeless mesh step.
"""

from __future__ import annotations

import dataclasses
import weakref
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import builds
from repro_torch.core import partitioners
from repro_torch.core.didic import (
    _INIT_LOAD,
    DidicConfig,
    DidicState,
    _capture_pins,
    _init_state,
    _make_step,
    _restore_pins,
    _smooth_schedule,
)
from repro_torch.distributed.counters import data_shard_count
from repro_torch.distributed.halo import build_halo_program, make_partitioned_spmm
from repro_torch.distributed.placement import PartitionedLayout, build_layout
from repro_torch.graphs.structure import Graph

__all__ = ["didic_partition_distributed", "didic_refine_distributed"]


def _distributed_coefficients(graph: Graph) -> np.ndarray:
    """Metropolis edge coefficients (as ``didic._edge_coefficients``)."""
    s, r, wt = graph.undirected
    deg = graph.weighted_degree
    return (wt / (1.0 + np.maximum(deg[s], deg[r]))).astype(np.float32)


def _block(layout: PartitionedLayout, mesh) -> slice:
    """This rank's rows of the padded layout."""
    return slice(mesh.rank * layout.block, (mesh.rank + 1) * layout.block)


def _mesh_program(graph: Graph, mesh, data_axes: Tuple[str, ...],
                  bootstrap_parts: Optional[np.ndarray] = None):
    """``(layout, halo spmm, this rank's degc)`` for DiDiC on ``mesh``,
    cached on the graph per (mesh, axes). The layout is placement, not
    partitioning: vertices stay on their bootstrap shard while their
    partition label diffuses, so one program serves the initial pass and
    every maintenance pass. Only an explicit ``bootstrap_parts`` bypasses
    the cache."""
    cache = graph.__dict__.setdefault("_torch_didic_mesh_cache", {})
    key = (mesh, tuple(data_axes)) if bootstrap_parts is None else None
    if key is not None and key in cache:
        return cache[key]
    n_shards = data_shard_count(mesh, data_axes)
    if bootstrap_parts is None:
        bootstrap_parts = partitioners.linear_partition(graph.n_nodes, n_shards)
    layout = build_layout(graph, bootstrap_parts, n_shards)
    ce = _distributed_coefficients(graph)
    spmm = make_partitioned_spmm(build_halo_program(graph, layout, edge_weights=ce),
                                 mesh, data_axes)
    # degc in the padded layout (padding rows have zero degree: inert).
    s, _, _ = graph.undirected
    degc_host = np.zeros(graph.n_nodes, dtype=np.float64)
    np.add.at(degc_host, s, ce)
    degc = layout.scatter_features(degc_host.astype(np.float32))[_block(layout, mesh)]
    out = (layout, spmm, torch.as_tensor(degc, device=mesh.device))
    if key is not None:
        cache[key] = out
    return out


def _sharded_state(layout: PartitionedLayout, k: int, parts_padded: np.ndarray, mesh) -> DidicState:
    """Fresh state of this rank's block, seeded from a padded map."""
    local = torch.as_tensor(np.ascontiguousarray(parts_padded[_block(layout, mesh)]),
                            dtype=torch.int32, device=mesh.device)
    return _init_state(k, local)


def _run_mesh(state: DidicState, spmm, degc, config: DidicConfig, mesh,
              layout: PartitionedLayout, iterations: int, seed: int,
              start_wide: bool, live: Optional[torch.Tensor] = None,
              live_n: Optional[int] = None) -> DidicState:
    def allreduce(t: torch.Tensor) -> torch.Tensor:
        return mesh.all_reduce(t.reshape(-1)).reshape(t.shape)

    step = _make_step(spmm, degc, config, allreduce=allreduce, n_rows=layout.padded_n,
                      live=live, live_n=live_n)
    schedule = _smooth_schedule(config, iterations, start_wide)
    dev = mesh.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = _block(layout, mesh)
    w, l, parts, beta = state.w, state.l, state.parts, state.beta
    for it in range(iterations):
        # The same mask on every rank (same seed); each keeps its rows.
        commit = (torch.rand(layout.padded_n, generator=gen, device=dev)
                  < config.commit_prob)[rows]
        w, l, parts, beta = step(w, l, parts, beta, commit, int(schedule[it]))
    return DidicState(w=w, l=l, parts=parts, beta=beta)


# ===========================================================================
# The capacity mesh program (store-backed graphs)
# ===========================================================================
class _CapacityMeshProgram:
    """The halo product, coefficient degrees and live mask of this rank's
    block, over a layout of the store's capacity.

    The layout places ``n_cap`` rows linearly over the shards once; every
    grown graph sharing the store adopts into it (:meth:`adopt`): the halo
    tables are rebuilt for its edges and checked against the capacity bounds
    the JAX program pads to (``2·e_cap`` edges a shard, ghosts from the
    other shards' blocks). Torch has no compiled shape to keep, so the
    tables keep the grown graph's own widths. Dead rows are inert: no edge
    reaches them, their coefficient degree is 0 and the step masks every
    reduction to the live rows.
    """

    def __init__(self, store, mesh, data_axes: Tuple[str, ...], n_shards: int):
        boot = partitioners.linear_partition(store.n_cap, n_shards)
        # build_layout reads only ``n_nodes`` of its graph.
        self.layout = build_layout(SimpleNamespace(n_nodes=store.n_cap), boot, n_shards)
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.e_max = max(1, 2 * store.e_cap)  # symmetrized edges ≤ 2·e_cap
        self.b_max = max(1, self.layout.block)
        self.g_max = max(1, min(self.e_max, (n_shards - 1) * self.b_max))
        self._graph = None
        self.extents: Optional[Tuple[int, int]] = None
        self.spmm = self.degc = self.live = None
        builds.note_build("mesh_program", (store.n_cap, store.e_cap))

    def adopt(self, graph: Graph) -> None:
        """Rebuild the tables for ``graph`` (nothing to do when it is the
        graph the program holds)."""
        extents = (graph.n_nodes, graph.n_edges)
        if self._graph is not None and self._graph() is graph and extents == self.extents:
            return
        layout, mesh = self.layout, self.mesh
        self.spmm = self.degc = self.live = None  # one set of tables at a time
        ce = _distributed_coefficients(graph)
        prog = build_halo_program(graph, layout, edge_weights=ce)
        if prog.e_max > self.e_max or prog.g_max > self.g_max:
            raise ValueError(
                f"graph exceeds the capacity program (edges {prog.e_max} > "
                f"{self.e_max} or ghosts {prog.g_max} > {self.g_max})"
            )
        n = graph.n_nodes
        rows = layout.old_to_new[:n]
        s, _, _ = graph.undirected
        degc_host = np.zeros(n, dtype=np.float64)
        np.add.at(degc_host, s, ce)
        degc = np.zeros(layout.padded_n, dtype=np.float32)
        degc[rows] = degc_host.astype(np.float32)
        live = np.zeros(layout.padded_n, dtype=bool)
        live[rows] = True
        block = _block(layout, mesh)
        self.spmm = make_partitioned_spmm(prog, mesh, self.data_axes)
        self.degc = torch.as_tensor(degc[block], device=mesh.device)
        self.live = torch.as_tensor(live[block], device=mesh.device)
        self._graph = weakref.ref(graph)
        self.extents = extents
        builds.note_refresh("mesh_program_tables", extents)


def _capacity_mesh_program(graph: Graph, mesh, data_axes: Tuple[str, ...]) -> _CapacityMeshProgram:
    """One program per (store, mesh, axes), cached on the store with no
    extents in the key: growth adopts, only a compaction (a new store, with
    fresh ``caches``) builds anew."""
    store = graph.store
    key = ("mesh_program", mesh, tuple(data_axes))
    prog = store.caches.get(key)
    if prog is None:
        prog = _CapacityMeshProgram(store, mesh, data_axes, data_shard_count(mesh, data_axes))
        store.caches[key] = prog
    prog.adopt(graph)
    return prog


def _refine_capacity(graph: Graph, parts: np.ndarray, config: DidicConfig, mesh,
                     data_axes: Tuple[str, ...], state: Optional[DidicState],
                     iterations: int, seed: int) -> Tuple[np.ndarray, DidicState]:
    """Sharded maintenance through the capacity mesh program; a state of
    another block size (cold, or across a compaction) is reseeded."""
    prog = _capacity_mesh_program(graph, mesh, data_axes)
    layout = prog.layout
    _check_k(config, layout)
    n = graph.n_nodes
    rows = layout.old_to_new[:n]
    padded = np.zeros(layout.padded_n, dtype=np.int32)
    padded[rows] = np.asarray(parts, dtype=np.int32)
    local = torch.as_tensor(np.ascontiguousarray(padded[_block(layout, mesh)]),
                            dtype=torch.int32, device=mesh.device)
    if state is None or state.w.shape[0] != layout.block:
        classes = torch.arange(config.k, dtype=torch.int32, device=mesh.device)
        load = _INIT_LOAD * ((local[:, None] == classes[None, :])
                             & prog.live[:, None]).to(torch.float32)
        state = DidicState(w=load, l=load, parts=local,
                           beta=torch.ones((config.k,), dtype=torch.float32, device=mesh.device))
    state = DidicState(w=state.w, l=state.l, parts=local, beta=state.beta)
    state = _run_mesh(state, prog.spmm, prog.degc, config, mesh, layout, iterations, seed,
                      start_wide=True, live=prog.live, live_n=n)
    full = torch.cat(mesh.all_gather(state.parts), dim=0).cpu().numpy()
    return full[rows], state


def _gather_parts(parts: torch.Tensor, layout: PartitionedLayout, mesh) -> np.ndarray:
    """Every rank's block, as a map in original vertex ids."""
    padded = torch.cat(mesh.all_gather(parts), dim=0).cpu().numpy()
    return padded[layout.old_to_new]


def _check_k(config: DidicConfig, layout: PartitionedLayout) -> None:
    if config.k % layout.n_shards:
        raise ValueError(f"k={config.k} must be a multiple of shards={layout.n_shards}")


def didic_partition_distributed(
    graph: Graph,
    config: DidicConfig,
    mesh,
    data_axes: Tuple[str, ...] = ("data",),
    seed: int = 0,
    bootstrap_parts: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, PartitionedLayout]:
    """Run DiDiC with rank-resident loads and halo-exchange diffusion.

    Returns (parts[N] in original vertex ids, equal on every rank; the
    bootstrap layout). ``config.k`` must be a multiple of the shard count.
    """
    layout, spmm, degc = _mesh_program(graph, mesh, data_axes, bootstrap_parts)
    _check_k(config, layout)
    rng = np.random.default_rng(seed)
    parts0 = rng.integers(0, config.k, size=graph.n_nodes).astype(np.int32)
    state = _sharded_state(layout, config.k, layout.scatter_features(parts0, fill=0), mesh)
    state = _run_mesh(state, spmm, degc, config, mesh, layout, config.iterations, seed,
                      start_wide=False)
    return _gather_parts(state.parts, layout, mesh), layout


def didic_refine_distributed(
    graph: Graph,
    parts: np.ndarray,
    config: DidicConfig,
    mesh,
    data_axes: Tuple[str, ...] = ("data",),
    state: Optional[DidicState] = None,
    iterations: int = 1,
    seed: int = 0,
    pinned: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, DidicState]:
    """Maintenance pass on the mesh (the sharded twin of ``didic_refine``).

    Seeds the assignment from ``parts`` (the input map always wins over the
    state's), runs at full smoothing width with deterministic commit, and
    returns (parts[N] in original ids, the carried state: this rank's
    block of loads, its map block and the balance scalars). Feed the state
    back on the next call. ``pinned`` vertices keep their assignment,
    restored on the host in the returned map. A store-backed graph runs the
    capacity mesh program (module docstring).
    """
    config = dataclasses.replace(config, commit_prob=1.0)
    pinned, before = _capture_pins(parts, pinned)
    if graph.store is not None:
        out, state = _refine_capacity(graph, parts, config, mesh, tuple(data_axes), state,
                                      iterations, seed)
        return _restore_pins(out, pinned, before), state
    layout, spmm, degc = _mesh_program(graph, mesh, data_axes)
    _check_k(config, layout)
    padded = layout.scatter_features(np.asarray(parts, dtype=np.int32), fill=0)
    if state is None:
        state = _sharded_state(layout, config.k, padded, mesh)
    local = torch.as_tensor(np.ascontiguousarray(padded[_block(layout, mesh)]),
                            dtype=torch.int32, device=mesh.device)
    state = DidicState(w=state.w, l=state.l, parts=local, beta=state.beta)
    state = _run_mesh(state, spmm, degc, config, mesh, layout, iterations, seed,
                      start_wide=True)
    return _restore_pins(_gather_parts(state.parts, layout, mesh), pinned, before), state
