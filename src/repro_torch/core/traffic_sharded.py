"""Sharded traffic replay over a process group (twin of ``repro.core.traffic_sharded``).

The batched engine (:mod:`repro_torch.core.traffic_batched`) replays a
log on one device. This module splits the **log** over the ranks of a
:class:`~repro_torch.launch.mesh.ReplayMesh`: every rank runs the same
program on the same inputs, holds the whole graph and the engine's
layouts (as the JAX replayer replicates them on every device), solves its
share of the ops, and meets the other ranks in collectives. Rank 0's
result is the result, and every rank's equals it.

**Linear BFS sweep (filesystem, Twitter).** The level-prefix tables are
ops-independent. Each rank gathers the per-op counters of its contiguous
chunk of ops from them, and one ``all_gather`` puts the counters in log
order on every rank. The per-vertex frontier mass ``tm`` is linear in the
ops, so each rank folds its own level histograms through the ``Σ_l (Aᵀ)^l
c_l`` cascade and one ``all_reduce`` publishes the wave's total. Waves are
cut by :func:`bfs_wave_ranges` as in the JAX package (whose device counts
in int32); torch counts in int64, and the host fold is kept.

**Windowed batched SSSP (GIS).** Each round hands every rank one chunk of
ops in the engine's difficulty order, packed by the engine's own
:meth:`~repro_torch.core.traffic_batched.BatchedTrafficEngine.build_sssp_problem`
and solved by its own ``_sssp_solve`` (on the card every round launches
``frontier_gather``), so the distances, and with them the A* expansion
sets, are the batched engine's bit for bit. A rank's per-op counters and
its per-vertex mass stay local until the pass ends; then one
``all_reduce`` merges the per-op counters (each op is written by one
rank) and one scatter ``all_reduce`` the mass. Window acceptance stays on
the host in float64; rejected ops are solved again on the whole graph,
whose layout each rank builds once and keeps (the replicated redo
layout).

Every reduction is integer and every float path is the batched engine's,
so :func:`replay_sharded` is bit-equal to
``execute_ops(..., engine="batched")`` on all four counters, for any
world size and any split of the log, idle ranks included.

**Resident replay.** A log's solve artifacts split into a parts-independent
majority (GIS membership and invalidation-footprint masks, per-op edge
counts, BFS expansion levels and frontier mass) and the parts-dependent
cross counters. :class:`ResidentReplayState` keeps the former across
replays of one log, each rank its own rounds, so replaying the log against
a new partition map is an integer ``member × cross_deg`` fold. Structural
dynamism dirties the touched vertices; ops whose footprint meets them are
solved again through the whole-graph layout on the next replay
(:func:`migrate_resident_states` carries states onto a grown graph).

**On a growth store.** A storeless graph's replayers are cached on the
graph object, and a grown graph gets replayers of its own. A graph backed by
a :class:`~repro_torch.graphs.structure.GraphStore` shares one replayer per
parameters with its whole lineage, cached on the store: its counters are
sized to the store's row capacity, and :meth:`ShardedTrafficReplayer.adopt_graph`
moves it, its engine (which adopts in place) and its resident states onto
each grown graph. :func:`migrate_resident_states` handles the three places a
replayer can live, as the JAX package does. Replayers and resident states
hold their graph weakly.
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import builds
from repro_torch.core.traffic_batched import _sssp_solve, get_engine, resolve_max_expansions
from repro_torch.distributed.counters import (
    CounterAccumulator,
    data_shard_count,
    make_scatter_psum,
)
from repro_torch.graphs.structure import Graph

__all__ = [
    "ResidentReplayState",
    "ShardedTrafficReplayer",
    "bfs_wave_ranges",
    "get_replayer",
    "migrate_resident_states",
    "replay_sharded",
]

# Per-(wave, shard) bound on Σ(1 + edges_op), as in the JAX package (whose
# device counts the frontier mass in int32: 2³⁰ is half its range).
_WAVE_BUDGET = 1 << 30
# Rows a resident cross fold multiplies at once ([rows, C] int64 scratch).
_FOLD_ROWS = 1 << 16


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def bfs_wave_ranges(per_op_edges: np.ndarray, budget: Optional[int] = None):
    """Contiguous op ranges whose Σ(1+edges) ≤ ``budget`` each (every wave
    has ≥ 1 op); real logs fit in one wave. A range's work may equal the
    budget exactly; only the op that would exceed it starts a new wave."""
    budget = _WAVE_BUDGET if budget is None else budget
    work = np.cumsum(1 + per_op_edges.astype(np.int64))
    waves, lo = [], 0
    while lo < per_op_edges.shape[0]:
        base = work[lo - 1] if lo else 0
        hi = int(np.searchsorted(work, base + budget, side="right"))
        hi = max(hi, lo + 1)
        waves.append((lo, hi))
        lo = hi
    return waves


# ===========================================================================
# Resident replay state
# ===========================================================================
class _ResidentRound:
    """One solved GIS round of this rank: the layout's global row ids
    (``[W]``, ``_BIG_ID`` padding), the solve's membership and footprint
    masks ``[W, C]``, the op of each column (``-1`` padding) and ``ok``,
    the columns whose counters this round owns (an op rejected by its
    window, or evicted by a dirty set, is owned by a later redo round)."""

    __slots__ = ("ids", "member", "foot", "opidx", "ok")

    def __init__(self, ids, member, foot, opidx, ok):
        self.ids, self.member, self.foot, self.opidx, self.ok = ids, member, foot, opidx, ok


class ResidentReplayState:
    """Parts-independent solve artifacts of one (graph, log), kept across
    replays (module docstring).

    ``per_op_edges``/``tm`` are graph-pure int64 host counters, equal on
    every rank; ``rounds`` hold this rank's GIS masks on its device;
    ``bfs_starts``/``bfs_levels`` this rank's BFS gather columns.
    ``mark_dirty`` queues structurally touched vertices, which the owning
    replayer turns into dirty ops (footprint intersection) and solves again
    on the next replay.
    """

    def __init__(self, graph: Graph, pattern: str, n_ops: int):
        self.graph = graph
        self.pattern = pattern
        self.n_ops = n_ops
        self.reset()

    @property
    def graph(self) -> Optional[Graph]:
        return self._graph()

    @graph.setter
    def graph(self, graph: Graph) -> None:
        self._graph = weakref.ref(graph)
        self.n_nodes = graph.n_nodes

    @property
    def solved(self) -> bool:
        return self.per_op_edges is not None and self.tm is not None

    def mark_dirty(self, vertices) -> None:
        """Queue structurally touched vertices for op invalidation."""
        v = np.unique(np.asarray(vertices, dtype=np.int64))
        if v.size == 0:
            return
        self.pending_dirty = v if self.pending_dirty is None else np.union1d(self.pending_dirty, v)

    def reset(self) -> None:
        """Drop every artifact (the next replay is a full cold solve)."""
        self.per_op_edges: Optional[np.ndarray] = None
        self.tm: Optional[np.ndarray] = None
        self.bfs_starts: Optional[torch.Tensor] = None
        self.bfs_levels: Optional[torch.Tensor] = None
        self.rounds: List[_ResidentRound] = []
        self.dirty_ops: Optional[np.ndarray] = None
        self.pending_dirty: Optional[np.ndarray] = None

    def state_bytes(self) -> int:
        """Footprint of this rank's artifacts in bytes, from shapes and
        dtypes only (no transfer). The GIS round masks dominate."""
        arrays = [self.per_op_edges, self.tm, self.bfs_starts, self.bfs_levels,
                  self.dirty_ops, self.pending_dirty]
        for rnd in self.rounds:
            arrays.extend([rnd.ids, rnd.member, rnd.foot, rnd.opidx, rnd.ok])
        total = 0
        for a in arrays:
            if isinstance(a, torch.Tensor):
                total += a.numel() * a.element_size()
            elif a is not None:
                total += int(a.size) * int(a.dtype.itemsize)
        return total


class ShardedTrafficReplayer:
    """Replay evaluation logs split over a mesh's ranks; one replayer per
    (graph, pattern, mesh, engine parameters), cached by
    :func:`get_replayer`. Its engine is the batched engine of the same
    graph and parameters on the mesh's device, so the two share layouts."""

    def __init__(
        self,
        graph: Graph,
        pattern: str,
        mesh,
        data_axes: Tuple[str, ...] = ("data",),
        chunk: Optional[int] = None,
        max_expansions: Optional[int] = None,
        delta_scale: Optional[float] = None,
    ):
        self._graph = weakref.ref(graph)
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.n_shards = data_shard_count(mesh, self.data_axes)
        self.rank = mesh.rank
        self.engine = get_engine(graph, pattern, chunk=chunk, max_expansions=max_expansions,
                                 delta_scale=delta_scale, device=mesh.device)
        self.n_nodes = graph.n_nodes
        # Rows of the mass scatter: the store's capacity on a store (real ids
        # always fit; rows past the live ones stay 0 and are sliced off).
        self._row_cap = graph.store.n_cap if graph.store is not None else graph.n_nodes
        self.last_redo_ops = 0  # ops solved on the whole graph by the last replay
        self._scatter_psum = make_scatter_psum(mesh, self._row_cap, self.data_axes)
        self._deg_table: Optional[torch.Tensor] = None
        builds.note_build(f"replayer:{pattern}", builds.geometry(graph))

    @property
    def graph(self) -> Optional[Graph]:
        return self._graph()

    def adopt_graph(self, graph: Graph) -> None:
        """Adopt a grown graph of the same store lineage in place: the engine
        adopts it (its buffers written in place) and the graph-pure deg
        prefix table is rebuilt on the next BFS replay."""
        if graph is self.graph:
            return
        self.engine.adopt(graph)
        self._graph = weakref.ref(graph)
        self.n_nodes = graph.n_nodes
        self._deg_table = None

    def _my_range(self, lo: int, hi: int) -> Tuple[int, int]:
        """This rank's contiguous share of ``[lo, hi)``."""
        b = _ceil_div(max(hi - lo, 1), self.n_shards)
        return min(hi, lo + self.rank * b), min(hi, lo + (self.rank + 1) * b)

    # =================================================== linear BFS patterns
    def _prefix_one(self, vec: torch.Tensor) -> torch.Tensor:
        """``[N, t+1]`` level-prefix table of one per-vertex column."""
        eng = self.engine
        prefixes = [torch.zeros_like(vec)]
        level = vec
        for _ in range(eng.max_levels):
            prefixes.append(prefixes[-1] + level)
            level = eng._spmv_down(level)
        return torch.stack(prefixes, dim=1)

    def _gather_log(self, cols: torch.Tensor, n_ops: int) -> np.ndarray:
        """``[c, m]`` columns of this rank's contiguous chunk of ops →
        ``[c, n_ops]`` in log order, on every rank."""
        b = _ceil_div(max(n_ops, 1), self.n_shards)
        pad = torch.zeros((cols.shape[0], b), dtype=torch.int64, device=cols.device)
        pad[:, : cols.shape[1]] = cols
        return torch.cat(self.mesh.all_gather(pad), dim=1)[:, :n_ops].cpu().numpy()

    def _tm_wave(self, starts: np.ndarray, levels: np.ndarray) -> torch.Tensor:
        """This rank's ops of one wave folded into per-vertex frontier mass
        (``tm = Σ_l (Aᵀ)^l c_l``), summed over the ranks."""
        eng = self.engine
        t, n = eng.max_levels, eng.n_nodes
        idx = (np.minimum(levels, t) - 1) * n + starts
        hist = torch.zeros(t * n, dtype=torch.int64, device=eng.device)
        hist.index_add_(0, eng._tensor(idx, torch.int64),
                        torch.ones(idx.shape[0], dtype=torch.int64, device=eng.device))
        c = hist.view(t, n).flip(0).cumsum(0).flip(0)
        tm = c[t - 1]
        for lvl in range(t - 2, -1, -1):
            tm = c[lvl] + torch.zeros_like(tm).index_add_(0, eng._r_t, tm[eng._s_t])
        return self.mesh.all_reduce(tm)

    def _run_bfs(self, ops, cross_deg: np.ndarray, state: Optional[ResidentReplayState] = None):
        eng = self.engine
        n_ops = ops.n_ops
        if state is not None and state.pending_dirty is not None:
            # BFS artifacts are global properties of the tree or edge list:
            # a structural insert invalidates them wholesale.
            state.reset()
        cross_table = self._prefix_one(eng._tensor(cross_deg, torch.int64))
        if state is not None and state.solved:
            cross = self._gather_log(cross_table[state.bfs_starts, state.bfs_levels][None], n_ops)[0]
            return state.per_op_edges, cross, state.tm

        levels, _ = eng._compile_bfs_log(ops)
        lo, hi = self._my_range(0, n_ops)
        st = eng._tensor(ops.starts[lo:hi], torch.int64)
        lvl = eng._tensor(levels[lo:hi], torch.int64)
        if self._deg_table is None:
            self._deg_table = self._prefix_one(eng._deg_t)
        both = self._gather_log(torch.stack([self._deg_table[st, lvl], cross_table[st, lvl]]), n_ops)
        edges, cross = both[0].copy(), both[1].copy()

        # The frontier mass is (graph, ops)-pure, so a resident state keeps
        # it across replays against an evolving partition map.
        acc = CounterAccumulator(self.n_nodes)
        for wlo, whi in bfs_wave_ranges(edges):
            a, b = self._my_range(wlo, whi)
            acc.add(self._tm_wave(ops.starts[a:b].astype(np.int64), levels[a:b]))
        tm = acc.total[: self.n_nodes]
        if state is not None:
            state.bfs_starts, state.bfs_levels = st, lvl
            state.per_op_edges, state.tm = edges, tm
        return edges, cross, tm

    # ====================================================== GIS batched SSSP
    def _solve_pass(self, ops, op_idx: np.ndarray, cross_deg: np.ndarray, full: bool,
                    state: Optional[ResidentReplayState] = None):
        """Solve ``op_idx`` in rounds of ``S·chunk`` ops, this rank's chunk
        of each (on its window, or with ``full`` on the whole-graph layout),
        then merge over the ranks. Returns ``(edges [n_ops], cross [n_ops],
        ok [n_ops] bool, tm [rows])``, equal on every rank; ``ok`` marks the
        ops accepted by their window. With ``state``, each round's masks
        are kept as a resident round."""
        eng = self.engine
        s, chunk, n_ops = self.n_shards, eng.chunk, ops.n_ops
        local = np.zeros(3 * n_ops + 1, dtype=np.int64)  # edges, cross, ok, failed
        ids_l, mass_l = [], []
        if full:
            w_pad, nbr, w_inf, tail, ids_w, deg_w = eng.ensure_full_layout()
            row_order = eng.full_row_order()
            cross_w = torch.zeros(w_pad, dtype=torch.int64, device=eng.device)
            cross_w[: self.n_nodes] = eng._tensor(cross_deg, torch.int64)
        for lo in range(0, op_idx.shape[0], s * chunk):
            idx = op_idx[lo + self.rank * chunk: lo + (self.rank + 1) * chunk]
            n = idx.shape[0]
            if not n:
                continue  # idle this round
            pad = chunk - n
            srcs = np.concatenate([ops.starts[idx], np.zeros(pad, np.int64)])
            dsts = np.concatenate([ops.ends[idx], np.zeros(pad, np.int64)])
            valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
            if full:
                loc_src, loc_dst, dst_ids, valid_t, h = eng.full_per_op(srcs, dsts, valid)
                args = (loc_src, loc_dst, dst_ids, valid_t, deg_w, cross_w, ids_w,
                        nbr, w_inf, tail, row_order, h)
                box, eff_full = None, True
            else:
                args, _, _, box, eff_full = eng.build_sssp_problem(srcs, dsts, valid, cross_deg, False)
            out = _sssp_solve(
                *args, float(eng.delta),
                max_expansions=eng.max_expansions,
                finite_delta=eng.delta_scale is not None,
                footprint=state is not None,
            )
            member, (edges, cross, f_dst, done) = out[0], out[-4:]
            if not bool(done.all()):
                local[-1] = 1  # the max_rounds backstop tripped: raise on every rank below
                break
            ok = eng.window_accept(srcs, dsts, valid, f_dst.double().cpu().numpy(), box, eff_full)
            taken = idx[ok[:n]]
            local[taken] = edges.cpu().numpy()[:n][ok[:n]]
            local[n_ops + taken] = cross.cpu().numpy()[:n][ok[:n]]
            local[2 * n_ops + taken] = 1
            ok_t = eng._tensor(ok)
            ids_l.append(args[6])
            mass_l.append((member & ok_t[None, :]).sum(dim=1))
            if state is not None:
                opidx = np.full(chunk, -1, dtype=np.int64)
                opidx[:n] = idx
                state.rounds.append(_ResidentRound(args[6], member, out[1], opidx, ok.copy()))
        merged = self.mesh.all_reduce(torch.from_numpy(local)).numpy()
        if merged[-1]:
            raise RuntimeError(
                "sharded SSSP hit its round cap before all ops settled; "
                "raise delta_scale (or use delta_scale=None)"
            )
        tm = self._scatter_psum(*self._cat_rows(ids_l, mass_l)).cpu().numpy()
        return (merged[:n_ops].copy(), merged[n_ops:2 * n_ops].copy(),
                merged[2 * n_ops:3 * n_ops] > 0, tm)

    def _cat_rows(self, ids_l, mass_l):
        dev = self.engine.device
        if not ids_l:
            return (torch.zeros(0, dtype=torch.int64, device=dev),
                    torch.zeros(0, dtype=torch.int64, device=dev))
        return torch.cat([i.long() for i in ids_l]), torch.cat(mass_l)

    def _run_sssp(self, ops, cross_deg: np.ndarray, state: Optional[ResidentReplayState] = None):
        if state is not None and state.solved:
            return self._replay_resident_sssp(ops, cross_deg, state)
        if state is not None:
            # A cold solve that died mid-pass may have kept some rounds.
            state.reset()
        order = self.engine._compile_sssp_log(ops)
        edges, cross, ok, tm = self._solve_pass(ops, order, cross_deg, False, state)
        redo = order[~ok[order]]  # rejected ops, in round and rank order
        self.last_redo_ops = int(redo.shape[0])
        if redo.size:
            e2, c2, _, tm2 = self._solve_pass(ops, redo, cross_deg, True, state)
            edges[redo] = e2[redo]
            cross[redo] = c2[redo]
            tm = tm + tm2
        tm = tm[: self.n_nodes]
        if state is not None:
            state.per_op_edges = edges
            state.tm = tm
            state.dirty_ops = np.zeros(ops.n_ops, dtype=bool)
        return edges, cross, tm

    # ------------------------------------------------- resident replay path
    def _rows_of(self, rnd: _ResidentRound, table: torch.Tensor) -> torch.Tensor:
        """``table`` (``[rows + 1]``, a sentinel last) at the round's row ids."""
        return table[torch.clamp(rnd.ids.long(), max=self._row_cap)]

    def _replay_resident_sssp(self, ops, cross_deg: np.ndarray, state: ResidentReplayState):
        """Per-slice GIS replay from resident artifacts: absorb queued dirty
        vertices into dirty ops, solve exactly those again on the whole
        graph, then fold ``member × cross_deg`` over the resident masks."""
        self.last_redo_ops = 0
        if state.pending_dirty is not None:
            self._absorb_dirty(state)
        if state.dirty_ops is not None and state.dirty_ops.any():
            self._redo_dirty(ops, state, cross_deg)
        state.rounds = [r for r in state.rounds if r.ok.any()]

        eng = self.engine
        cross_full = torch.zeros(self._row_cap + 1, dtype=torch.int64, device=eng.device)
        cross_full[: self.n_nodes] = eng._tensor(cross_deg, torch.int64)
        local = np.zeros(state.n_ops, dtype=np.int64)
        for rnd in state.rounds:
            rows = self._rows_of(rnd, cross_full)
            ch = torch.zeros(rnd.member.shape[1], dtype=torch.int64, device=eng.device)
            for a in range(0, rows.shape[0], _FOLD_ROWS):
                ch += (rnd.member[a:a + _FOLD_ROWS].long() * rows[a:a + _FOLD_ROWS, None]).sum(dim=0)
            local[rnd.opidx[rnd.ok]] = ch.cpu().numpy()[rnd.ok]
        per_op_cross = self.mesh.all_reduce(torch.from_numpy(local)).numpy()
        return state.per_op_edges, per_op_cross, state.tm

    def _absorb_dirty(self, state: ResidentReplayState) -> None:
        """Turn queued dirty vertices into dirty ops (on any rank's rounds)
        and evict their columns, membership mass included, from every
        round."""
        pend, state.pending_dirty = state.pending_dirty, None
        if pend is None or pend.size == 0:
            return
        eng = self.engine
        dirty_full = torch.zeros(self._row_cap + 1, dtype=torch.bool, device=eng.device)
        dirty_full[eng._tensor(pend[pend < self.n_nodes], torch.int64)] = True
        if state.dirty_ops is None:
            state.dirty_ops = np.zeros(state.n_ops, dtype=bool)

        touched_ops = np.zeros(state.n_ops, dtype=np.int64)
        for rnd in state.rounds:
            touched = (rnd.foot & self._rows_of(rnd, dirty_full)[:, None]).any(dim=0)
            touched = touched.cpu().numpy() & (rnd.opidx >= 0)
            touched_ops[rnd.opidx[touched]] = 1
        new_dirty = self.mesh.all_reduce(torch.from_numpy(touched_ops)).numpy() > 0
        new_dirty &= ~state.dirty_ops
        if not new_dirty.any():
            return
        ids_l, mass_l = [], []
        for rnd in state.rounds:
            cols = (rnd.opidx >= 0) & new_dirty[np.clip(rnd.opidx, 0, None)]
            if not cols.any():
                continue
            removed_ok = cols & rnd.ok
            if removed_ok.any():
                # Subtract the evicted columns' per-vertex mass; the redo
                # pass adds the re-solved mass back (both integer, exact).
                ids_l.append(rnd.ids)
                mass_l.append((rnd.member & eng._tensor(removed_ok)[None, :]).sum(dim=1))
            keep = eng._tensor(~cols)[None, :]
            rnd.member = rnd.member & keep
            rnd.foot = rnd.foot & keep
            rnd.ok &= ~cols
        removed = self._scatter_psum(*self._cat_rows(ids_l, mass_l))
        state.tm = state.tm - removed[: self.n_nodes].cpu().numpy()
        state.dirty_ops |= new_dirty

    def _redo_dirty(self, ops, state: ResidentReplayState, cross_deg: np.ndarray) -> None:
        """Solve the dirty ops again on the whole (possibly updated) graph,
        keeping the fresh artifacts as new resident rounds."""
        idx = np.nonzero(state.dirty_ops)[0]
        n_rounds = len(state.rounds)
        try:
            edges, _, _, tm = self._solve_pass(ops, idx, cross_deg, True, state)
        except Exception:
            # Rounds kept before a failure never had their mass folded in.
            del state.rounds[n_rounds:]
            raise
        state.per_op_edges[idx] = edges[idx]
        state.tm = state.tm + tm[: self.n_nodes]
        state.dirty_ops[:] = False
        self.last_redo_ops = int(idx.shape[0])

    def _resident_state(self, ops) -> ResidentReplayState:
        states = ops.__dict__.setdefault("_resident_replay", weakref.WeakKeyDictionary())
        st = states.get(self)
        if st is not None and st.graph is not self.graph:
            st = None  # artifacts of another structure: start cold
        if st is None:
            st = ResidentReplayState(self.graph, self.engine.pattern, ops.n_ops)
            states[self] = st
        return st

    def invalidate(self, ops, vertices) -> None:
        """Mark vertices structurally dirty for this log's resident state
        (nothing happens if the log was never replayed resident here)."""
        st = ops.__dict__.get("_resident_replay", {}).get(self)
        if st is not None:
            st.mark_dirty(vertices)

    def adopt_resident(self, ops, state: ResidentReplayState, dirty_vertices) -> None:
        """Adopt a resident state solved on a prior revision of this graph.

        The revision may only have added structure (edge inserts, appended
        vertices), and every vertex whose incident structure changed must be
        in ``dirty_vertices``. GIS ops whose footprint meets a dirty vertex
        are solved again on this replayer's graph, the rest stay exact; BFS
        states reset on their next replay but stay adopted.
        """
        if state.pattern != self.engine.pattern or state.n_nodes > self.n_nodes:
            raise ValueError("resident state is incompatible with this replayer")
        if state.n_ops != ops.n_ops:
            raise ValueError("resident state belongs to a different log")
        grown = self.n_nodes - state.n_nodes
        if grown and state.tm is not None:
            # Appended vertices carry zero mass until a redo touches them.
            state.tm = np.concatenate([state.tm, np.zeros(grown, dtype=state.tm.dtype)])
        state.graph = self.graph
        state.mark_dirty(dirty_vertices)
        ops.__dict__.setdefault("_resident_replay", weakref.WeakKeyDictionary())[self] = state

    # ------------------------------------------------------------------ run
    def replay(self, ops, parts: np.ndarray, k: int, resident: bool = True,
               replicated: Optional[np.ndarray] = None):
        """Replay ``ops`` against ``parts``. ``resident=True`` keeps and uses
        the log's parts-independent artifacts across calls (bit-identical
        results); ``resident=False`` is a full cold solve with no cache
        read or written. ``replicated`` masks hot vertices served by local
        replicas; it enters only through the host's ``cross_deg`` and
        finalize, so resident artifacts never depend on it."""
        self.mesh.check_live()
        parts = np.asarray(parts, dtype=np.int64)
        cross_deg = self.engine.cross_degree(parts, replicated=replicated)
        state = self._resident_state(ops) if resident else None
        if self.engine.kind == "bfs":
            edges, cross, tm64 = self._run_bfs(ops, cross_deg, state)
        else:
            edges, cross, tm64 = self._run_sssp(ops, cross_deg, state)
        return self.engine.finalize(edges, cross, tm64, parts, k, ops.t_l, ops.t_pg,
                                    replicated=replicated)


def get_replayer(
    graph: Graph,
    pattern: str,
    mesh,
    data_axes: Tuple[str, ...] = ("data",),
    chunk: Optional[int] = None,
    max_expansions: Optional[int] = None,
    delta_scale: Optional[float] = None,
) -> ShardedTrafficReplayer:
    """Replayer cache keyed by (pattern, mesh, axes, engine parameters),
    ``max_expansions`` normalized first so a replay without an override
    lands on the batched path's engine. A storeless graph's replayers live
    on the graph; a store-backed graph's on its store, where the cached
    replayer adopts each grown graph of the lineage (a cache hit)."""
    key = (pattern, mesh, tuple(data_axes), chunk, resolve_max_expansions(max_expansions),
           delta_scale)
    store = graph.store
    if store is not None:
        skey = ("replayer",) + key
        rep = store.caches.get(skey)
        if rep is not None:
            rep.adopt_graph(graph)
            if rep.engine._needs_rebuild:
                del store.caches[skey]
                rep = None
        if rep is None:
            rep = ShardedTrafficReplayer(
                graph, pattern, mesh, data_axes=data_axes, chunk=chunk,
                max_expansions=max_expansions, delta_scale=delta_scale,
            )
            store.caches[skey] = rep
        return rep
    cache = graph.__dict__.setdefault("_torch_traffic_replayer_cache", {})
    if key not in cache:
        cache[key] = ShardedTrafficReplayer(
            graph, pattern, mesh, data_axes=data_axes, chunk=chunk,
            max_expansions=max_expansions, delta_scale=delta_scale,
        )
    return cache[key]


def migrate_resident_states(ops, old_graph: Graph, new_graph: Graph, dirty_vertices) -> int:
    """Carry a log's resident states across a structural update (edge
    inserts, appended vertices): every replayer of ``old_graph`` holding a
    state for ``ops`` hands it to the equivalent replayer of ``new_graph``
    with ``dirty_vertices`` queued. A replayer lives in one of three places:
    the old graph's own cache (storeless growth, or a replay before the
    store was attached), a store both graphs share (the replayer adopts the
    new graph and keeps the state), or a store a compaction retired (the
    state moves to the new store's replayer). Returns the number of states
    moved."""
    states = ops.__dict__.get("_resident_replay")
    if not states:
        return 0
    moved = 0
    candidates = list(old_graph.__dict__.get("_torch_traffic_replayer_cache", {}).items())
    if old_graph.store is not None:
        candidates += [(skey[1:], rep) for skey, rep in old_graph.store.caches.items()
                       if isinstance(skey, tuple) and skey and skey[0] == "replayer"]
    new_store = new_graph.store
    for key, old_rep in candidates:
        state = states.pop(old_rep, None)
        if state is None:
            continue
        if new_store is not None and old_rep.engine.store is new_store:
            new_rep = old_rep
            new_rep.adopt_graph(new_graph)
        else:
            pattern, mesh, data_axes, chunk, max_exp, delta_scale = key
            new_rep = get_replayer(new_graph, pattern, mesh, data_axes=data_axes, chunk=chunk,
                                   max_expansions=max_exp, delta_scale=delta_scale)
        new_rep.adopt_resident(ops, state, dirty_vertices)
        moved += 1
    return moved


def replay_sharded(
    graph: Graph,
    log,
    mesh,
    parts: np.ndarray,
    k: Optional[int] = None,
    data_axes: Tuple[str, ...] = ("data",),
    chunk: Optional[int] = None,
    max_expansions: Optional[int] = None,
    delta_scale: Optional[float] = None,
    resident: bool = True,
    replicated: Optional[np.ndarray] = None,
):
    """Replay an evaluation log split over ``mesh``'s ranks: bit-equal to
    ``execute_ops(graph, log, parts, k, engine="batched")`` on all four
    counters. Every rank calls it with the same arguments; each returns
    the whole result. Raises when the mesh's process group is not open."""
    if mesh is None:
        raise ValueError("replay_sharded needs a mesh (repro_torch.launch.mesh.make_replay_mesh)")
    k = int(np.asarray(parts).max()) + 1 if k is None else k
    replayer = get_replayer(graph, log.pattern, mesh, data_axes=data_axes, chunk=chunk,
                            max_expansions=max_expansions, delta_scale=delta_scale)
    return replayer.replay(log, parts, k, resident=resident, replicated=replicated)
