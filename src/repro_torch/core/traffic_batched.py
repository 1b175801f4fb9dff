"""Batched execution of evaluation logs on a device (PyTorch).

Twin of ``repro.core.traffic_batched`` for graphs without a growth store.
A graph grown by dynamism is a new :class:`Graph` and gets engines of its
own from :func:`get_engine` (its layouts, and for GIS its Hilbert row
schedule, built afresh); the JAX package instead adopts the grown graph into
capacity-padded engines so that its compiled closures never retrace. The
engines hold no reference to their graph, and a log keeps its per-engine
compilations by weak reference, so an engine, and its device memory, goes
when its graph goes.

The log is packed into device tensors once and **all operations advance
together**; the four counters come out equal, bit for bit, to the scalar
oracle of :mod:`repro_torch.core.traffic`. Two strategies cover the
paper's three patterns:

**Linear BFS sweep (filesystem, Twitter).** A BFS op's frontier at level
``l`` is ``(Aᵀ)^l e_start`` (path multiplicity included), and every traffic
counter is *linear* in it, so the whole log collapses into closed form:

  per-op:     total[b] = (T_L+T_PG) · P[start_b, L_b],
              P[u, t]  = Σ_{l<t} (A^l deg)(u)   (level-prefix tables, one
              SpMV per level; the same table with ``cross_deg`` gives the
              global traffic),
  aggregate:  tm = Σ_t (Aᵀ)^t c_t,  c_t[u] = #{ops: start=u, L>t},
              per_vertex = T_L·deg⊙tm + T_PG·(Aᵀ tm).

Every SpMV is an int64 ``index_add_``: integer sums are exact in any order,
so the device and the host agree exactly. Torch has int64 on the device,
so the JAX package's int32-device / int64-host split is not needed.

**Batched windowed SSSP (GIS).** The per-op heapq A* becomes a batched
shortest-path sweep in vertex-major layout ``g [W, chunk]``: each round
relaxes every in-edge of every window vertex for every op at once through
:func:`repro_torch.kernels.frontier.frontier_relax` (the hand-written
``frontier_gather`` kernel on CUDA, its plain version on the CPU — min and
a single float32 add are exact in any order). The JAX package's
``lax.while_loop`` becomes a Python loop that checks on the host, every two
rounds, whether every op has retired, with the same ``max_rounds``
backstop. Ops are sorted by (coarse src cell, straight-line distance) and
each chunk runs on a *window* (the chunk's bounding box plus a margin); a
result is accepted only if the op's A* ellipse provably fits the window
(:meth:`BatchedTrafficEngine.window_accept`, host float64), and rejected
ops are solved again on the whole graph. Vertex ids are random in space, so
a large window also gets a *row schedule* for the kernel: its rows along a
Hilbert curve over the vertices' coordinates
(:meth:`BatchedTrafficEngine.row_order`), so that rows relaxed together
read neighbour rows that are still in the card's L2. The schedule changes
which rows run together, never a result, and rows keep their positions
(``max_expansions`` breaks ties by row position).

The accounting set is the deterministic A* expansion set of
:mod:`repro_torch.core.traffic`, decided from final float32 distances. The
heuristic rows are computed on the device with one eager op per
arithmetic step (``dx*dx``, ``dy*dy``, their sum, ``sqrt``), so nothing is
contracted into an FMA; an engine-init probe checks that they equal
NumPy's float32 rows bit for bit and falls back to host rows when not.
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import traffic as _t
from repro_torch.graphs.structure import Graph, padded_neighbors
from repro_torch.kernels.frontier import frontier_relax, spill_tail

__all__ = ["BatchedTrafficEngine", "execute_ops_batched", "get_engine"]

_BIG_ID = np.int32(2**31 - 1)
_DEFAULT_MAX_EXPANSIONS = 50_000


def resolve_max_expansions(max_expansions: Optional[int]) -> int:
    """Normalize a ``max_expansions`` override (None → engine default)."""
    return _DEFAULT_MAX_EXPANSIONS if max_expansions is None else int(max_expansions)


def _capped_gather_layout(
    s_loc: np.ndarray, r_loc: np.ndarray, w: np.ndarray, n_rows: int, cap: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Relaxation form of :func:`padded_neighbors` with a slot cap:
    (nbr, w_inf (+inf padded — the min-plus identity), spill_s, spill_r,
    spill_w), the spill sorted by receiver."""
    pn = padded_neighbors(s_loc, r_loc, w, n_rows, cap=cap)
    w_inf = np.where(pn.mask > 0, pn.w, np.float32(np.inf))
    return pn.nbr, w_inf, pn.spill_s, pn.spill_r, pn.spill_w


def _hilbert_rank(lon: np.ndarray, lat: np.ndarray, bits: int = 16) -> np.ndarray:
    """Each vertex's position (0..N-1, ties by id) along a Hilbert curve over
    a ``2^bits`` grid spanning the coordinates' bounding box."""
    n = 1 << bits

    def cell(a):
        lo, span = float(a.min()), max(float(a.max() - a.min()), 1e-12)
        return np.clip(((a.astype(np.float64) - lo) / span * n).astype(np.int64), 0, n - 1)

    x, y = cell(lon), cell(lat)
    key = np.zeros(x.shape[0], dtype=np.int64)
    s = n // 2
    while s > 0:  # xy2d, one bit of both coordinates a step
        rx = (x & s) > 0
        ry = (y & s) > 0
        key += s * s * ((3 * rx.astype(np.int64)) ^ ry.astype(np.int64))
        flip = ~ry & rx
        x = np.where(flip, n - 1 - x, x)
        y = np.where(flip, n - 1 - y, y)
        x, y = np.where(ry, x, y), np.where(ry, y, x)
        s //= 2
    rank = np.empty(x.shape[0], dtype=np.int64)
    rank[np.argsort(key, kind="stable")] = np.arange(x.shape[0])
    return rank


def _device_h(lon_w, lat_w, dst_lon, dst_lat) -> torch.Tensor:
    """[W, C] Euclidean heuristic rows; one eager op per arithmetic step so
    no multiply is fused into the add (see the module docstring)."""
    dx = lon_w[:, None] - dst_lon[None, :]
    dy = lat_w[:, None] - dst_lat[None, :]
    dxx = dx * dx
    dyy = dy * dy
    return torch.sqrt(dxx + dyy)


# ===========================================================================
# Windowed batched SSSP solve
# ===========================================================================
def _sssp_solve(
    starts,        # [C] int64 local src index
    ends,          # [C] int64 local dst index
    dst_ids,       # [C] int32 *global* dst vertex id (lex tie-break)
    valid,         # [C] bool
    deg_w,         # [W] int64 global degree, window rows
    cross_w,       # [W] int64 global cross-degree, window rows
    ids_w,         # [W] int32 global vertex ids (ascending; _BIG_ID padding)
    nbr,           # [W, D] int32 local in-neighbour ids (D capped)
    w_inf,         # [W, D] float32 edge weights (+inf where padded)
    tail,          # SpillTail of the over-cap edges by receiver, or None
    order,         # [W] int32 row schedule of the kernel, or None
    h,             # [W, C] float32 Euclidean heuristic to each op's dst
    delta: float,  # bucket width (ignored unless finite_delta)
    max_expansions: int,
    finite_delta: bool,
):
    """Twin of the JAX package's ``_sssp_solve_body``, op for op.

    Returns ``(member [W, C] bool, edges [C], cross [C], f_dst [C], done [C])``.
    """
    w_nodes, c = h.shape
    dev = h.device
    cols = torch.arange(c, device=dev)
    inf = float("inf")
    max_rounds = 4 * w_nodes + 16

    g = torch.full((w_nodes, c), inf, device=dev)
    g[starts, cols] = torch.zeros(c, device=dev).masked_fill(~valid, inf)
    need = torch.zeros((w_nodes, c), dtype=torch.bool, device=dev)
    need[starts, cols] = valid
    t = torch.full((c,), delta, dtype=torch.float32, device=dev)
    done = ~valid

    def step(g, need, t, done):
        if finite_delta:
            # Delta-stepping: relax only needs-relax nodes in the current
            # bucket; drained buckets advance to the next nonempty one.
            in_bucket = need & (g <= t[None, :]) & (~done)[None, :]
            any_f = in_bucket.any(dim=0)
            gm = torch.where(in_bucket, g, inf)
        else:
            # Frontier Bellman–Ford: every vertex re-offers its current
            # value; pending work is exactly "improved last round".
            gm = torch.where(done[None, :], inf, g)
        relaxed = frontier_relax(gm, nbr, w_inf, tail, order)
        improved = relaxed < g
        g = torch.minimum(g, relaxed)
        if finite_delta:
            need = (need & ~in_bucket) | improved
        else:
            need = improved
        # Retire ops whose every pending vertex is beyond the goal.
        min_need = torch.where(need, g, inf).amin(dim=0)
        g_dst = g[ends, cols]
        done = done | (min_need > g_dst) | ~need.any(dim=0)
        if finite_delta:
            t = torch.where(~any_f & ~done, min_need + delta, t)
        return g, need, t, done

    rounds = 0
    while rounds < max_rounds and not bool(done.all()):
        g, need, t, done = step(g, need, t, done)
        g, need, t, done = step(g, need, t, done)
        rounds += 2

    # Deterministic A* expansion set: (f, id) <_lex (f_dst, dst).
    f = g + h
    f_dst = f[ends, cols]
    member = (f < f_dst[None, :]) | (
        (f == f_dst[None, :]) & (ids_w[:, None] < dst_ids[None, :])
    )
    member = member & torch.isfinite(f) & valid[None, :]
    if w_nodes > max_expansions:
        # Keep the max_expansions lex-smallest members: a stable sort of f
        # ties by row position; rows ascend in global id, i.e. (f, id) order.
        key = torch.where(member, f, inf)
        order = torch.sort(key, dim=0, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(0, order, torch.arange(w_nodes, device=dev)[:, None].expand(w_nodes, c))
        member = member & (rank < max_expansions)

    m = member.long()
    edges = (m * deg_w[:, None]).sum(dim=0)
    cross = (m * cross_w[:, None]).sum(dim=0)
    return member, edges, cross, f_dst, done


class BatchedTrafficEngine:
    """One engine per (graph, pattern, device); see module docstring."""

    #: Windows of at least this many rows get a Hilbert row schedule
    #: (:meth:`row_order`); smaller ones run their rows in index order. On
    #: an H100 (10,000-op GIS replay, `python -m repro_torch.profile_replay
    #: --order-min-rows 0`) the schedule cut the kernel's device time by
    #: 6-8 % at 98,304-131,072 rows, 23 % at 262,144 and 24-34 % from
    #: 393,216 rows up, while building it costs ~0.4 ms of device and
    #: ~0.45 ms of host time a window: it pays from 393,216 rows (x of 201
    #: MB at C = 128, four times the L2), and for the whole-graph layout,
    #: whose schedule is built once.
    order_min_rows = 393_216

    def __init__(
        self,
        graph: Graph,
        pattern: str,
        chunk: Optional[int] = None,
        max_expansions: Optional[int] = None,
        delta_scale: Optional[float] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.pattern = pattern
        self.max_expansions = resolve_max_expansions(max_expansions)
        if pattern in ("filesystem", "twitter"):
            self.kind = "bfs"
        elif pattern in ("gis_short", "gis_long"):
            self.kind = "sssp"
        else:
            raise ValueError(f"unknown pattern {pattern!r}")

        self.n_nodes = graph.n_nodes
        if pattern == "filesystem":
            s, r = _t._filtered_children_csr_edges(graph)
            self.w = None
        elif pattern == "twitter":
            s, r = graph.senders, graph.receivers
            self.w = None
        else:
            s, r, w = graph.undirected
            self.w = np.asarray(w, dtype=np.float32)
        self.s = np.asarray(s, dtype=np.int64)
        self.r = np.asarray(r, dtype=np.int64)
        self.deg = np.bincount(self.s, minlength=self.n_nodes).astype(np.int32)
        dev = self.device

        if self.kind == "bfs":
            if pattern == "twitter":
                self.max_levels = 2
            else:
                self._depth = graph.node_attrs["depth"].astype(np.int64)
                self._parent = graph.node_attrs["parent"].astype(np.int64)
                self.max_levels = int(self._depth.max()) + 2
            self._s_t = torch.as_tensor(self.s, device=dev)
            self._r_t = torch.as_tensor(self.r, device=dev)
            self._deg_t = torch.as_tensor(self.deg, dtype=torch.int64, device=dev)
        else:
            self.chunk = chunk or 128
            self.delta_scale = delta_scale
            self._lon = np.asarray(graph.node_attrs["lon"], dtype=np.float32)
            self._lat = np.asarray(graph.node_attrs["lat"], dtype=np.float32)
            self._lon_t = torch.as_tensor(self._lon, device=dev)
            self._lat_t = torch.as_tensor(self._lat, device=dev)
            self.mean_w = float(self.w.mean()) if self.w.size else 1.0
            self.delta = (
                np.float32(np.inf)
                if delta_scale is None
                else np.float32(max(self.mean_w * delta_scale, 1e-6))
            )
            # The cap only splits edges between the padded gather and the
            # exact spill tail, so results never depend on it.
            pos_deg = self.deg[self.deg > 0]
            self.nbr_cap = max(4, int(np.percentile(pos_deg, 90)) if pos_deg.size else 4)
            self._glob2loc = np.full(self.n_nodes, -1, dtype=np.int64)
            self._rank_t = torch.as_tensor(_hilbert_rank(self._lon, self._lat), device=dev)
            self._full_layout = None
            self._full_order = None
            self._device_h_ok = self._check_device_h()

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # =================================================== linear BFS patterns
    def _spmv_down(self, x: torch.Tensor) -> torch.Tensor:
        """(A x)(u) = Σ_{u→c} x(c) — pull child values up one level."""
        return torch.zeros_like(x).index_add_(0, self._s_t, x[self._r_t])

    def _bfs_prefix_table(self, cross_deg: torch.Tensor) -> torch.Tensor:
        """Level-prefix tables ``P[u, l, :]`` for deg and cross_deg."""
        vec = torch.stack([self._deg_t, cross_deg], dim=1)  # [N, 2]
        prefixes = [torch.zeros_like(vec)]
        level_vec = vec
        for _ in range(self.max_levels):
            prefixes.append(prefixes[-1] + level_vec)
            level_vec = self._spmv_down(level_vec)
        return torch.stack(prefixes, dim=1)  # [N, t+1, 2]

    def _compile_bfs_log(self, ops) -> Tuple[np.ndarray, np.ndarray]:
        """Per-op expansion levels + per-level start histograms (cached on
        the log per engine, held weakly)."""
        cache = ops.__dict__.setdefault("_torch_bfs_compile_cache", weakref.WeakKeyDictionary())
        if self in cache:
            return cache[self]
        t = self.max_levels
        n_ops = ops.n_ops
        starts = ops.starts.astype(np.int64)
        if self.pattern == "twitter":
            levels = np.full(n_ops, 2, dtype=np.int64)
        else:
            depth, parent = self._depth, self._parent
            l_raw = depth[ops.ends] - depth[starts]
            cur = ops.ends.astype(np.int64).copy()
            steps = np.maximum(l_raw, 0).copy()
            for _ in range(int(depth.max()) + 1):
                walk = steps > 0
                cur = np.where(walk & (parent[cur] >= 0), parent[cur], cur)
                steps = np.maximum(steps - 1, 0)
            is_descendant = (l_raw > 0) & (cur == starts)
            levels = np.where(is_descendant, np.minimum(l_raw, t), t)
        # c_stack[l, u] = #ops with start u still expanding at level l (L > l).
        hist = np.zeros((t + 1, self.n_nodes), dtype=np.int64)
        np.add.at(hist, (np.minimum(levels, t) - 1, starts), 1)
        c_stack = hist[::-1].cumsum(axis=0)[::-1].copy()[:t]
        out = (levels, c_stack)
        cache[self] = out
        return out

    def _run_bfs(self, ops, cross_deg: np.ndarray):
        levels, c_stack = self._compile_bfs_log(ops)
        p = self._bfs_prefix_table(self._tensor(cross_deg, torch.int64))
        per_op = p[self._tensor(ops.starts, torch.int64), self._tensor(levels)]  # [n_ops, 2]
        # tm = Σ_l (Aᵀ)^l c_l, folded inner to outer in int64 on the device.
        c_t = self._tensor(c_stack)
        t = self.max_levels
        tm = c_t[t - 1]
        for lvl in range(t - 2, -1, -1):
            push = torch.zeros_like(tm).index_add_(0, self._r_t, tm[self._s_t])
            tm = c_t[lvl] + push
        per_op = per_op.cpu().numpy()
        return per_op[:, 0].copy(), per_op[:, 1].copy(), tm.cpu().numpy()

    # ====================================================== GIS batched SSSP
    def _check_device_h(self) -> bool:
        probe = np.arange(min(self.n_nodes, 64), dtype=np.int64)
        window = np.arange(min(self.n_nodes, 4096), dtype=np.int64)
        host = self._host_h(window, probe)
        dev = _device_h(
            self._lon_t[: window.shape[0]], self._lat_t[: window.shape[0]],
            self._lon_t[: probe.shape[0]], self._lat_t[: probe.shape[0]],
        ).cpu().numpy()
        return bool(np.array_equal(host, dev))

    def _host_h(self, window: np.ndarray, ends: np.ndarray) -> np.ndarray:
        dx = self._lon[window][:, None] - self._lon[ends][None, :]
        dy = self._lat[window][:, None] - self._lat[ends][None, :]
        return np.sqrt(dx * dx + dy * dy)  # [W, C]

    def _compile_sssp_log(self, ops) -> np.ndarray:
        """Difficulty order: (coarse src cell, straight-line distance),
        cached on the log per engine, held weakly."""
        cache = ops.__dict__.setdefault("_torch_sssp_compile_cache", weakref.WeakKeyDictionary())
        if self in cache:
            return cache[self]
        hd = np.hypot(
            self._lon[ops.starts].astype(np.float64) - self._lon[ops.ends],
            self._lat[ops.starts].astype(np.float64) - self._lat[ops.ends],
        )
        lon_span = max(float(self._lon.max() - self._lon.min()), 1e-9)
        lat_span = max(float(self._lat.max() - self._lat.min()), 1e-9)
        cx = np.clip(((self._lon[ops.starts] - self._lon.min()) / lon_span * 8), 0, 7).astype(np.int64)
        cy = np.clip(((self._lat[ops.starts] - self._lat.min()) / lat_span * 8), 0, 7).astype(np.int64)
        order = np.lexsort((hd, cx * 8 + cy))
        cache[self] = order
        return order

    def _sssp_window(
        self, srcs: np.ndarray, dsts: np.ndarray, full: bool
    ) -> Tuple[np.ndarray, Tuple[float, float, float, float]]:
        if full:
            return np.arange(self.n_nodes, dtype=np.int64), (
                -np.inf, np.inf, -np.inf, np.inf
            )
        pts_lon = np.concatenate([self._lon[srcs], self._lon[dsts]]).astype(np.float64)
        pts_lat = np.concatenate([self._lat[srcs], self._lat[dsts]]).astype(np.float64)
        h_max = float(
            np.hypot(self._lon[srcs].astype(np.float64) - self._lon[dsts],
                     self._lat[srcs].astype(np.float64) - self._lat[dsts]).max()
        )
        margin = 1.15 * h_max + 6.0 * self.mean_w + 0.01
        lo_x, hi_x = pts_lon.min() - margin, pts_lon.max() + margin
        lo_y, hi_y = pts_lat.min() - margin, pts_lat.max() + margin
        mask = (
            (self._lon >= lo_x) & (self._lon <= hi_x)
            & (self._lat >= lo_y) & (self._lat <= hi_y)
        )
        return np.nonzero(mask)[0], (lo_x, hi_x, lo_y, hi_y)

    def row_order(self, win_t: torch.Tensor, w_pad: int) -> Optional[torch.Tensor]:
        """The kernel's row schedule for a window: its ``W`` real rows (global
        ids ``win_t``, ascending) in Hilbert order, then the padding rows;
        ``None`` below :attr:`order_min_rows` rows, where the window's
        values fit the L2 anyway."""
        if w_pad < self.order_min_rows:
            return None
        order = torch.argsort(self._rank_t[win_t]).to(torch.int32)
        pad = torch.arange(win_t.shape[0], w_pad, dtype=torch.int32, device=self.device)
        return torch.cat([order, pad])

    def full_row_order(self) -> Optional[torch.Tensor]:
        """:meth:`row_order` of the whole-graph layout, built once."""
        w_pad = self.ensure_full_layout()[0]
        if w_pad < self.order_min_rows:
            return None
        if self._full_order is None:
            self._full_order = self.row_order(torch.arange(self.n_nodes, device=self.device), w_pad)
        return self._full_order

    def ensure_full_layout(self):
        """Whole-graph gather layout ``(w_pad, nbr, w_inf, tail, ids_w,
        deg_w)`` on the device — parts/ops independent, built once and used
        by every redo chunk."""
        if self._full_layout is None:
            self.build_sssp_problem(
                np.zeros(1, np.int64), np.zeros(1, np.int64),
                np.zeros(1, bool), np.zeros(self.n_nodes, np.int32), full=True,
            )
        return self._full_layout

    def build_sssp_problem(
        self,
        srcs: np.ndarray,
        dsts: np.ndarray,
        valid: np.ndarray,
        cross_deg: np.ndarray,
        full: bool,
    ):
        """Pack one op chunk into a solver problem on the device.

        Returns ``(args, window, w_real, box, full)`` where ``args`` is the
        positional-argument tuple of :func:`_sssp_solve` up to and including
        ``h`` (the row schedule, ``order``, just before it). ``full`` is
        returned because a near-full window is promoted to the whole graph
        here.
        """
        window, box = self._sssp_window(srcs[valid], dsts[valid], full)
        if not full and window.shape[0] > 0.6 * self.n_nodes:
            # Near-full window: run on the whole graph outright — cheaper
            # than risking a second (redo) pass for rejected ops.
            full = True
            window, box = self._sssp_window(srcs, dsts, True)
        w_real = window.shape[0]
        if full and self._full_layout is not None:
            w_pad, nbr, w_inf, tail, ids_w, deg_w = self._full_layout
        else:
            # Pad to a {2^k, 3·2^k} size grid (≤ 33 % padding waste), as the
            # JAX package does, so the layouts agree row for row.
            p2 = max(64, 1 << int(np.ceil(np.log2(max(w_real, 1)))))
            w_pad = 3 * p2 // 4 if w_real <= 3 * p2 // 4 else p2
            self._glob2loc[window] = np.arange(w_real)
            if full:
                es, er, ew = self.s, self.r, self.w
            else:
                e_mask = (self._glob2loc[self.s] >= 0) & (self._glob2loc[self.r] >= 0)
                es, er, ew = self.s[e_mask], self.r[e_mask], self.w[e_mask]
            nbr, w_inf, sp_s, sp_r, sp_w = _capped_gather_layout(
                self._glob2loc[es], self._glob2loc[er], ew, w_pad, self.nbr_cap
            )
            n_sp = sp_s.shape[0]
            if n_sp and (n_sp < 64 or n_sp & (n_sp - 1)):
                # The JAX package pads its spill tail to a {64, 128, ...}
                # size with edges 0 -> 0 of weight +inf; min is idempotent,
                # so one such edge stands for them all.
                sp_s = np.concatenate([np.zeros(1, np.int32), sp_s])
                sp_r = np.concatenate([np.zeros(1, np.int32), sp_r])
                sp_w = np.concatenate([np.full(1, np.inf, np.float32), sp_w])
            tail = spill_tail(sp_s, sp_r, sp_w, w_pad, self.device)
            ids = np.full(w_pad, _BIG_ID, dtype=np.int32)
            ids[:w_real] = window.astype(np.int32)
            deg = np.zeros(w_pad, dtype=np.int64)
            deg[:w_real] = self.deg[window]
            self._glob2loc[window] = -1  # restore the scratch map
            nbr = self._tensor(nbr, torch.int32)
            w_inf = self._tensor(w_inf, torch.float32)
            ids_w = self._tensor(ids)
            deg_w = self._tensor(deg)
            if full:
                self._full_layout = (w_pad, nbr, w_inf, tail, ids_w, deg_w)

        cross = np.zeros(w_pad, dtype=np.int64)
        cross[:w_real] = cross_deg[window]

        if full:
            loc_src = np.where(valid, srcs, 0)
            loc_dst = np.where(valid, dsts, 0)
        else:
            self._glob2loc[window] = np.arange(w_real)
            loc_src = np.where(valid, self._glob2loc[srcs], 0)
            loc_dst = np.where(valid, self._glob2loc[dsts], 0)
            self._glob2loc[window] = -1  # restore the scratch map
        dst_safe = np.where(valid, dsts, 0)
        win_t = self._tensor(window)
        order = self.full_row_order() if full else self.row_order(win_t, w_pad)
        if self._device_h_ok:
            lon_w = torch.zeros(w_pad, dtype=torch.float32, device=self.device)
            lat_w = torch.zeros(w_pad, dtype=torch.float32, device=self.device)
            lon_w[:w_real] = self._lon_t[win_t]
            lat_w[:w_real] = self._lat_t[win_t]
            dst_t = self._tensor(dst_safe)
            h = _device_h(lon_w, lat_w, self._lon_t[dst_t], self._lat_t[dst_t])
        else:
            h_host = np.zeros((w_pad, srcs.shape[0]), dtype=np.float32)
            h_host[:w_real] = self._host_h(window, dst_safe)
            h = self._tensor(h_host)

        args = (
            self._tensor(loc_src, torch.int64), self._tensor(loc_dst, torch.int64),
            self._tensor(dst_safe.astype(np.int32)), self._tensor(valid),
            deg_w, self._tensor(cross), ids_w,
            nbr, w_inf, tail, order, h,
        )
        return args, window, w_real, box, full

    def window_accept(
        self,
        srcs: np.ndarray,
        dsts: np.ndarray,
        valid: np.ndarray,
        f_dst: np.ndarray,
        box,
        full: bool,
    ) -> np.ndarray:
        """Exactness gate: accept only ops whose A* ellipse provably fits
        the window — disk(src, f_dst) ∪ disk(dst, f_dst) inside the box
        (with a small safety factor over float32 rounding). Host-side in
        float64 on purpose: a float32 false-accept would silently break
        the bit-exactness contract, a false-reject only costs a redo."""
        if full:
            return valid.copy()
        lo_x, hi_x, lo_y, hi_y = box
        rad = np.asarray(f_dst, dtype=np.float64) * 1.00001 + 1e-6
        sx = self._lon[srcs].astype(np.float64)
        sy = self._lat[srcs].astype(np.float64)
        tx = self._lon[dsts].astype(np.float64)
        ty = self._lat[dsts].astype(np.float64)
        return (
            valid & np.isfinite(f_dst)
            & (sx - rad >= lo_x) & (sx + rad <= hi_x)
            & (sy - rad >= lo_y) & (sy + rad <= hi_y)
            & (tx - rad >= lo_x) & (tx + rad <= hi_x)
            & (ty - rad >= lo_y) & (ty + rad <= hi_y)
        )

    def _solve_sssp_chunk(self, srcs, dsts, valid, cross_deg, full: bool):
        """Solve one op chunk on its window; returns host arrays (window,
        w_real, per-window-row accepted member counts, edges, cross, ok)."""
        args, window, w_real, box, full = self.build_sssp_problem(
            srcs, dsts, valid, cross_deg, full
        )
        member, edges, cross, f_dst, done = _sssp_solve(
            *args, float(self.delta),
            max_expansions=self.max_expansions,
            finite_delta=self.delta_scale is not None,
        )
        if not bool(done.all()):
            # The max_rounds backstop tripped: distances may be
            # under-relaxed — never silently return wrong counters.
            raise RuntimeError(
                "batched SSSP hit its round cap before all ops settled; "
                "raise delta_scale (or use delta_scale=None)"
            )
        f_dst = f_dst.double().cpu().numpy()
        ok = self.window_accept(srcs, dsts, valid, f_dst, box, full)
        counts = (member[:w_real] & self._tensor(ok)[None, :]).sum(dim=1)
        return window, counts.cpu().numpy(), edges.cpu().numpy(), cross.cpu().numpy(), ok

    def _run_sssp(self, ops, cross_deg: np.ndarray):
        order = self._compile_sssp_log(ops)
        n_ops = ops.n_ops
        chunk = self.chunk
        per_op_edges = np.zeros(n_ops, dtype=np.int64)
        per_op_cross = np.zeros(n_ops, dtype=np.int64)
        tm64 = np.zeros(self.n_nodes, dtype=np.int64)
        redo: List[np.ndarray] = []

        def run_pass(op_idx: np.ndarray, full: bool) -> None:
            for lo in range(0, op_idx.shape[0], chunk):
                idx = op_idx[lo:lo + chunk]
                n = idx.shape[0]
                pad = chunk - n
                srcs = np.concatenate([ops.starts[idx], np.zeros(pad, np.int64)])
                dsts = np.concatenate([ops.ends[idx], np.zeros(pad, np.int64)])
                valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
                window, counts, edges, cross, ok = self._solve_sssp_chunk(
                    srcs, dsts, valid, cross_deg, full
                )
                accepted = idx[ok[:n]]
                per_op_edges[accepted] = edges[:n][ok[:n]]
                per_op_cross[accepted] = cross[:n][ok[:n]]
                tm64[window] += counts
                if not full:
                    rejected = idx[~ok[:n]]
                    if rejected.size:
                        redo.append(rejected)

        run_pass(order, full=False)
        if redo:
            run_pass(np.concatenate(redo), full=True)
        return per_op_edges, per_op_cross, tm64

    # ------------------------------------------------------------------ run
    def cross_degree(self, parts: np.ndarray) -> np.ndarray:
        """Per-vertex count of out-edges crossing a partition boundary."""
        parts = np.asarray(parts, dtype=np.int64)
        crossing = parts[self.s] != parts[self.r]
        return np.bincount(self.s, weights=crossing, minlength=self.n_nodes).astype(np.int64)

    def finalize(
        self,
        edges: np.ndarray,
        cross: np.ndarray,
        tm64: np.ndarray,
        parts: np.ndarray,
        k: int,
        t_l: int,
        t_pg: int,
    ):
        """Aggregate counters from the total frontier mass (host, int64)."""
        parts = np.asarray(parts, dtype=np.int64)
        deg64 = self.deg.astype(np.int64)
        pv = t_l * deg64 * tm64
        tpg_push = np.zeros(self.n_nodes, dtype=np.int64)
        np.add.at(tpg_push, self.r, tm64[self.s])
        pv += t_pg * tpg_push
        per_partition = np.zeros(k, dtype=np.int64)
        np.add.at(per_partition, parts, pv)
        return _t.TrafficResult(
            per_op_total=edges * (t_l + t_pg),
            per_op_global=cross,
            per_partition=per_partition,
            per_vertex=pv,
        )

    def run(self, ops, parts: np.ndarray, k: int, t_l: int, t_pg: int):
        parts = np.asarray(parts, dtype=np.int64)
        cross_deg = self.cross_degree(parts)
        if self.kind == "bfs":
            edges, cross, tm64 = self._run_bfs(ops, cross_deg)
        else:
            edges, cross, tm64 = self._run_sssp(ops, cross_deg)
        return self.finalize(edges, cross, tm64, parts, k, t_l, t_pg)


def get_engine(
    graph: Graph,
    pattern: str,
    chunk: Optional[int] = None,
    max_expansions: Optional[int] = None,
    delta_scale: Optional[float] = None,
    device=None,
) -> BatchedTrafficEngine:
    """Engine cache with the graph's lifetime, keyed by engine parameters
    (``max_expansions`` normalized first) and device. A grown graph is a
    new object, so it gets new engines; the old graph's go with it."""
    dev = resolve_device(device)
    key = (pattern, chunk, resolve_max_expansions(max_expansions), delta_scale, str(dev))
    cache = graph.__dict__.setdefault("_torch_traffic_engine_cache", {})
    if key not in cache:
        cache[key] = BatchedTrafficEngine(
            graph, pattern, chunk=chunk, max_expansions=max_expansions,
            delta_scale=delta_scale, device=dev,
        )
    return cache[key]


def execute_ops_batched(
    graph: Graph,
    ops,
    parts: np.ndarray,
    k: int,
    chunk: Optional[int] = None,
    max_expansions: Optional[int] = None,
    delta_scale: Optional[float] = None,
    device=None,
):
    engine = get_engine(
        graph, ops.pattern, chunk=chunk, max_expansions=max_expansions,
        delta_scale=delta_scale, device=device,
    )
    return engine.run(ops, parts, k, t_l=ops.t_l, t_pg=ops.t_pg)
