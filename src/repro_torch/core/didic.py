"""DiDiC — Distributed Diffusive Clustering (paper §4.1.3), on a device.

Twin of ``repro.core.didic``. One DiDiC iteration is a pair of coupled diffusion systems per partition ``c``; with the
symmetrized edge list and the per-edge coefficient ``c_e = wt(e)·α(e)``
(Metropolis weights ``α(e) = 1/(1 + max(D_u, D_v))``) every inner step is a
sparse product ``A_c @ X`` on an ``N×k`` load matrix:

  secondary (Eq. 4.7):  l ← l − degc⊙(l/b) + A_c @ (l/b)
  primary   (Eq. 4.6):  w ← w + l − degc⊙w + A_c @ w
  assignment (Eq. 4.8): π(v) = argmax_c smoothed_v(c)·β_c

followed, as in the JAX package, by the column-common rescale, the
annealed lazy-random-walk smoothing, the ScaleBalance fit of β and a
random commit mask (see the JAX module's docstring for why each is there).

``A_c @ X`` has two routes (:func:`make_spmm`):

* **segment** (the default, and the route at the paper's scale): a
  fixed-order per-row reduction. The coefficient edges stay sorted by
  sender, as ``coalesce_edges`` leaves them; rows are grouped into buckets
  of power-of-two width, each bucket gathers ``[rows, width, k]`` neighbour
  values, multiplies by the zero-padded coefficients and sums over the
  width axis, and the row sums are written back with ``index_copy_``
  (each row once). No atomics, so the result is the same from run to run
  on the card; float ``index_add_`` would not be.
* **kernel** (``DidicConfig.use_kernel``): the block-ELL packing of
  ``A_c`` through the hand-written ``bell_matmul`` kernel. The packing keeps
  vertex ids, so its size grows with how far a 128-row block's neighbours
  spread over the id range; it fits reduced scales only.

The commit mask (``jax.random.bernoulli`` in the JAX package) is drawn
from a ``torch.Generator`` seeded from ``seed``; the step takes it as an
argument, and :func:`didic_partition` / :func:`didic_refine` accept
``commit_masks`` so that tests can feed in the masks JAX's key schedule
draws.

**The capacity overlay.** A graph backed by a
:class:`~repro_torch.graphs.structure.GraphStore` is refined, off the kernel
route, by the JAX package's overlay step: the same algorithm on state with
``n_cap + 1`` rows, of which the first ``n_nodes`` are live. Seeds, the
rescale's mean, the balance fit's sizes and the commit are masked to the
live rows, the commit mask has ``n_cap + 1`` entries, and dead rows hold
exactly zero (their coefficient degree is 0 and no edge reaches them, so
every product leaves them 0). The product is the segment route over the
live, sender-sorted coefficient edges with ``n_cap + 1`` output rows: the
padded edges of the JAX tables carry coefficient 0 and point at the dead
sentinel row, so leaving them out changes no sum, and the reduction stays
fixed-order (no float atomics, so a card run repeats itself bit for bit).
The tables are cached on the store per graph and rebuilt when the lineage
grows (:func:`_overlay_tables`). Like the JAX step, the overlay sums floats
over padded rows, so it is close to, not bit-identical with, the storeless
step.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import builds, resolve_device
from repro_torch.graphs.structure import Graph

__all__ = ["DidicConfig", "DidicState", "didic_partition", "didic_refine", "make_spmm"]

_BENEFIT = 10.0     # b_u(c) for members of π_c (paper Eq. 4.7)
_INIT_LOAD = 100.0  # initial load per vertex in its own system (Eq. 4.5)


@dataclasses.dataclass(frozen=True)
class DidicConfig:
    """DiDiC hyper-parameters (paper defaults: T=100 initial, T=1 repair)."""

    k: int = 4
    iterations: int = 100        # T
    primary_steps: int = 11      # ψ
    secondary_steps: int = 9     # ρ
    smooth_cap: int = 64         # max assignment-smoothing depth
    smooth_double_every: int = 10
    commit_prob: float = 0.9     # stochastic-asynchrony commit probability
    balance_iters: int = 8       # ScaleBalance fitting iterations
    balance_exp: float = 0.25    # ScaleBalance damping exponent
    use_kernel: bool = False     # bell_matmul route instead of the segment route
    block_size: int = 128


@dataclasses.dataclass
class DidicState:
    """Carried diffusion state (device tensors)."""

    w: torch.Tensor      # [N, k] float32 primary loads
    l: torch.Tensor      # [N, k] float32 secondary loads
    parts: torch.Tensor  # [N] int32 current assignment
    beta: torch.Tensor   # [k] float32 balance scalars


def _edge_coefficients(graph: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrized edges + Metropolis-scaled coefficients + coeff degree
    (host numpy, cached on the graph; identical to the JAX package's)."""
    cached = graph.__dict__.get("_didic_coeff_cache")
    if cached is not None:
        return cached
    s, r, wt = graph.undirected
    deg = graph.weighted_degree
    alpha = 1.0 / (1.0 + np.maximum(deg[s], deg[r]))
    ce = (wt * alpha).astype(np.float32)
    degc = np.zeros(graph.n_nodes, dtype=np.float64)
    np.add.at(degc, s, ce)
    out = (s.astype(np.int32), r.astype(np.int32), ce, degc.astype(np.float32))
    graph.__dict__["_didic_coeff_cache"] = out
    return out


class SegmentSpmm:
    """``A_c @ X`` as a fixed-order per-row reduction (module docstring).

    ``s`` must be sorted ascending (each row's edges contiguous, in the
    order ``coalesce_edges`` left them); a row's sum runs over its edges in
    that order, padded with zero coefficients to the bucket width.
    """

    def __init__(self, s: np.ndarray, r: np.ndarray, ce: np.ndarray, n: int, device):
        s = np.asarray(s, dtype=np.int64)
        if s.size and np.any(np.diff(s) < 0):
            raise ValueError("SegmentSpmm needs edges sorted by sender")
        counts = np.bincount(s, minlength=n)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rows = np.nonzero(counts)[0]
        width = 1 << np.ceil(np.log2(counts[rows])).astype(np.int64)
        self.n = n
        self.buckets: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        for wd in np.unique(width):
            rb = rows[width == wd]
            slot = np.arange(wd)[None, :]
            live = slot < counts[rb][:, None]
            pos = np.where(live, starts[rb][:, None] + slot, 0)
            nbr = np.where(live, np.asarray(r, dtype=np.int64)[pos], 0)
            coef = np.where(live, ce[pos], np.float32(0.0)).astype(np.float32)
            self.buckets.append((
                torch.as_tensor(rb, device=device),
                torch.as_tensor(nbr, device=device),
                torch.as_tensor(coef, device=device),
            ))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.n, x.shape[1]), dtype=x.dtype, device=x.device)
        for rows, nbr, coef in self.buckets:
            out.index_copy_(0, rows, (x[nbr] * coef[:, :, None]).sum(dim=1))
        return out


def make_spmm(
    graph: Graph, config: DidicConfig, device=None,
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], torch.Tensor]:
    """Return (spmm(X) -> A_c @ X, degc) for the DiDiC coefficient matrix,
    cached on the graph per route and device."""
    dev = resolve_device(device)
    cache = graph.__dict__.setdefault("_torch_didic_spmm_cache", {})
    key = (config.use_kernel, config.block_size, str(dev))
    if key in cache:
        return cache[key]
    s, r, ce, degc = _edge_coefficients(graph)
    n = graph.n_nodes
    if config.use_kernel:
        from repro_torch.kernels.bsr_spmm import make_bell_matmul

        coeff_graph = Graph(
            n_nodes=n, senders=s, receivers=r, edge_weight=ce, name="didic_coeff"
        )
        bell = coeff_graph.to_block_ell(block_size=config.block_size, undirected=False)
        kernel_mm = make_bell_matmul(bell, device=dev)
        pad = bell.padded_rows - n

        def spmm(x: torch.Tensor) -> torch.Tensor:
            return kernel_mm(F.pad(x, (0, 0, 0, pad)))[:n]
    else:
        spmm = SegmentSpmm(s, r, ce, n, dev)
    cache[key] = (spmm, torch.as_tensor(degc, device=dev))
    return cache[key]


def _make_step(spmm: Callable, degc: torch.Tensor, config: DidicConfig,
               allreduce: Optional[Callable] = None, n_rows: Optional[int] = None,
               live: Optional[torch.Tensor] = None, live_n: Optional[int] = None):
    """One DiDiC iteration; the commit mask is an argument.

    On a mesh (:mod:`repro_torch.core.didic_distributed`) each rank steps
    its own block of rows: ``allreduce`` sums a tensor over the ranks, for
    the rescale's mean and the balance fit's sizes, and ``n_rows`` is the
    row count of all the blocks. ``live`` (a bool mask of the rows this
    call steps) and ``live_n`` (the live rows over every rank) make it the
    capacity-overlay step (module docstring)."""
    k = config.k
    safe_deg = torch.clamp(degc, min=1e-6)[:, None]
    degc = degc[:, None]
    classes = torch.arange(k, dtype=torch.int32, device=degc.device)
    livef = None if live is None else live.to(torch.float32)[:, None]

    def step(w, l, parts, beta, commit, smooth_steps: int):
        if live is not None:
            n = live_n
        else:
            n = w.shape[0] if n_rows is None else n_rows
        onehot = (parts[:, None] == classes[None, :]).to(w.dtype)
        if livef is not None:
            onehot = onehot * livef
        # Fresh per-member secondary seed with an ε-floor (JAX fix #1); on
        # the overlay, exactly zero on dead rows.
        l = _INIT_LOAD * onehot + 0.01
        if livef is not None:
            l = l * livef
        benefit = 1.0 + (_BENEFIT - 1.0) * onehot  # 10 for members, else 1
        for _ in range(config.primary_steps):
            for _ in range(config.secondary_steps):
                lb = l / benefit
                l = l - degc * lb + spmm(lb)
            w = w + l - degc * w + spmm(w)
        if allreduce is None and live is None:
            mean = w.mean()
        else:
            total = w.sum() if allreduce is None else allreduce(w.sum())
            mean = total / (n * k)  # dead rows sum to 0
        w = w / torch.clamp(mean, min=1e-6)  # column-common rescale
        # Annealed lazy-random-walk assignment smoothing (fixes #3, #4).
        smoothed = w
        for _ in range(smooth_steps):
            smoothed = 0.5 * smoothed + 0.5 * spmm(smoothed) / safe_deg
        # ScaleBalance (fix #2): fit β so argmax sizes approach N/k.
        tgt = n / k
        for _ in range(config.balance_iters):
            p = torch.argmax(smoothed * beta[None, :], dim=1)
            if live is None:
                sizes = torch.bincount(p, minlength=k)
            else:
                sizes = torch.bincount(torch.where(live, p, k), minlength=k + 1)[:k]
            sizes = (sizes if allreduce is None else allreduce(sizes)).to(w.dtype)
            beta = torch.clamp(
                beta * (tgt / torch.clamp(sizes, min=1.0)) ** config.balance_exp, 1e-3, 1e3
            )
        new_parts = torch.argmax(smoothed * beta[None, :], dim=1).to(torch.int32)
        if live is not None:
            commit = commit & live
        parts = torch.where(commit, new_parts, parts)
        return w, l, parts, beta

    return step


def _overlay_tables(graph: Graph, device) -> Tuple[SegmentSpmm, torch.Tensor]:
    """The capacity-padded coefficient product and degree of a store-backed
    graph: ``A_c @ X`` over ``n_cap + 1`` rows (the live edges only; see the
    module docstring) and ``degc`` zero past the live rows."""
    store = graph.store
    s, r, ce, degc = _edge_coefficients(graph)
    n_rows = store.n_cap + 1
    if s.shape[0] > 2 * store.e_cap:  # symmetrization: ≤ 2·e_cap edges
        raise ValueError(
            f"graph has {s.shape[0]} symmetrized edges but the store caps "
            f"the overlay at {2 * store.e_cap}"
        )
    degc_pad = torch.zeros(n_rows, dtype=torch.float32, device=device)
    degc_pad[: graph.n_nodes] = torch.from_numpy(degc)
    return SegmentSpmm(s, r, ce, n_rows, device), degc_pad


def _overlay_tables_for(graph: Graph, device) -> Tuple[SegmentSpmm, torch.Tensor]:
    """:func:`_overlay_tables`, cached on the store per device. The entry is
    kept for the graph it was built from (held weakly) and its extents, and
    dropped before its successor is built, so a lineage holds one set of
    tables at a time. (Keying on the extents alone, as the JAX package does,
    could serve one lineage's tables to another grown from the same base to
    the same size.)"""
    store = graph.store
    key = ("didic_tables", str(device))
    extents = (graph.n_nodes, graph.n_edges)
    ent = store.caches.get(key)
    if ent is not None and ent[0]() is graph and ent[1] == extents:
        return ent[2]
    store.caches.pop(key, None)
    ent = (weakref.ref(graph), extents, _overlay_tables(graph, device))
    store.caches[key] = ent
    builds.note_refresh("didic_tables", extents)
    return ent[2]


def _overlay_refine(
    graph: Graph,
    parts: np.ndarray,
    config: DidicConfig,
    state: Optional[DidicState],
    iterations: int,
    seed: int,
    device,
    commit_masks: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[np.ndarray, DidicState]:
    """Refine a store-backed graph through the capacity-overlay step. The
    state has ``n_cap + 1`` rows; one of another shape (cold, or carried
    across a compaction) is reseeded from ``parts``."""
    store = graph.store
    spmm, degc = _overlay_tables_for(graph, device)
    n, n_rows = graph.n_nodes, store.n_cap + 1
    parts_pad = np.zeros(n_rows, dtype=np.int32)
    parts_pad[:n] = np.asarray(parts, dtype=np.int32)
    parts_t = torch.as_tensor(parts_pad, device=device)
    live = torch.arange(n_rows, device=device) < n
    if state is None or state.w.shape[0] != n_rows:
        classes = torch.arange(config.k, dtype=torch.int32, device=device)
        onehot = (parts_t[:, None] == classes[None, :]) & live[:, None]
        load = _INIT_LOAD * onehot.to(torch.float32)
        state = DidicState(w=load, l=load, parts=parts_t,
                           beta=torch.ones((config.k,), dtype=torch.float32, device=device))
    else:
        state = DidicState(w=state.w, l=state.l, parts=parts_t, beta=state.beta)
    state = _run_iterations(
        state, spmm, degc, config, iterations, seed, start_wide=True,
        commit_masks=commit_masks, live=live, live_n=n,
    )
    return state.parts[:n].cpu().numpy(), state


def _init_state(k: int, parts0: torch.Tensor) -> DidicState:
    classes = torch.arange(k, dtype=parts0.dtype, device=parts0.device)
    load = _INIT_LOAD * (parts0[:, None] == classes[None, :]).to(torch.float32)
    return DidicState(
        w=load, l=load, parts=parts0.to(torch.int32),
        beta=torch.ones((k,), dtype=torch.float32, device=parts0.device),
    )


def _smooth_schedule(config: DidicConfig, iterations: int, start_wide: bool) -> np.ndarray:
    if start_wide:
        return np.full(iterations, config.smooth_cap, dtype=np.int32)
    sched = np.minimum(
        1 << (np.arange(iterations) // max(config.smooth_double_every, 1)),
        config.smooth_cap,
    )
    return sched.astype(np.int32)


def _run_iterations(
    state: DidicState,
    spmm: Callable,
    degc: torch.Tensor,
    config: DidicConfig,
    iterations: int,
    seed: int,
    start_wide: bool = False,
    commit_masks: Optional[Sequence[np.ndarray]] = None,
    live: Optional[torch.Tensor] = None,
    live_n: Optional[int] = None,
) -> DidicState:
    step = _make_step(spmm, degc, config, live=live, live_n=live_n)
    schedule = _smooth_schedule(config, iterations, start_wide)
    dev = state.w.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = state.w.shape[0]
    w, l, parts, beta = state.w, state.l, state.parts, state.beta
    for it in range(iterations):
        if commit_masks is None:
            commit = torch.rand(n, generator=gen, device=dev) < config.commit_prob
        else:
            commit = torch.as_tensor(np.array(commit_masks[it], dtype=bool), device=dev)
        w, l, parts, beta = step(w, l, parts, beta, commit, int(schedule[it]))
    return DidicState(w=w, l=l, parts=parts, beta=beta)


def didic_partition(
    graph: Graph,
    config: DidicConfig,
    seed: int = 0,
    init_parts: Optional[np.ndarray] = None,
    device=None,
    commit_masks: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[np.ndarray, DidicState]:
    """Partition ``graph`` into ``config.k`` parts from a random start
    (the paper's setup: ``config.iterations`` iterations, 100 for the
    static experiment). Returns (parts[N] int32 on host, final state).

    ``commit_masks`` (tests only) supplies one bool[N] mask per iteration
    in place of the generator's draws.
    """
    dev = resolve_device(device)
    if init_parts is None:
        rng = np.random.default_rng(seed)
        init_parts = rng.integers(0, config.k, size=graph.n_nodes)
    parts0 = torch.as_tensor(np.array(init_parts, dtype=np.int32), device=dev)
    spmm, degc = make_spmm(graph, config, dev)
    state = _init_state(config.k, parts0)
    state = _run_iterations(
        state, spmm, degc, config, config.iterations, seed, commit_masks=commit_masks
    )
    return state.parts.cpu().numpy(), state


def didic_refine(
    graph: Graph,
    parts: np.ndarray,
    config: DidicConfig,
    state: Optional[DidicState] = None,
    iterations: int = 1,
    seed: int = 0,
    device=None,
    commit_masks: Optional[Sequence[np.ndarray]] = None,
    pinned: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, DidicState]:
    """Repair/maintain an existing partitioning (paper Stress/Dynamic
    experiments): seeds loads from ``parts``, runs at full smoothing width
    and commits deterministically (``commit_prob=1``), as the JAX package
    does. ``commit_masks`` as in :func:`didic_partition`.

    ``pinned`` vertices (the placement's replicated hot set) keep their
    incoming assignment: diffusion runs unchanged and the pins are restored
    on the host in the returned map. The next refine seeds the carried
    state's assignment from its input map, so the pins carry over.

    A store-backed graph off the kernel route runs the capacity-overlay
    step (module docstring; ``commit_masks`` then have ``n_cap + 1``
    entries); the kernel route keeps the per-graph block-ELL packing.
    """
    dev = resolve_device(device)
    config = dataclasses.replace(config, commit_prob=1.0)
    pinned, before = _capture_pins(parts, pinned)
    if graph.store is not None and not config.use_kernel:
        out, state = _overlay_refine(graph, parts, config, state, iterations, seed, dev,
                                     commit_masks=commit_masks)
        return _restore_pins(out, pinned, before), state
    parts_t = torch.as_tensor(np.array(parts, dtype=np.int32), device=dev)
    spmm, degc = make_spmm(graph, config, dev)
    if state is None:
        state = _init_state(config.k, parts_t)
    else:
        state = DidicState(w=state.w, l=state.l, parts=parts_t, beta=state.beta)
    state = _run_iterations(
        state, spmm, degc, config, iterations, seed, start_wide=True,
        commit_masks=commit_masks,
    )
    return _restore_pins(state.parts.cpu().numpy(), pinned, before), state


def _capture_pins(
    parts: np.ndarray, pinned: Optional[np.ndarray]
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Pinned vertices and their assignments before a refine pass."""
    if pinned is None:
        return None, None
    pinned = np.asarray(pinned, dtype=np.int64)
    if pinned.size == 0:
        return None, None
    return pinned, np.asarray(parts)[pinned].copy()


def _restore_pins(
    new_parts: np.ndarray,
    pinned: Optional[np.ndarray],
    before: Optional[np.ndarray],
) -> np.ndarray:
    """Re-apply the pinned assignments to a refined map (an empty pin set
    returns the map itself)."""
    if pinned is None:
        return new_parts
    out = np.asarray(new_parts).copy()
    out[pinned] = before
    return out
