"""DiDiC — Distributed Diffusive Clustering (paper §4.1.3), on a device.

Twin of ``repro.core.didic`` for graphs without a growth store (the
capacity-overlay path comes with the dynamic slice). One DiDiC iteration is
a pair of coupled diffusion systems per partition ``c``; with the
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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
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


def _make_step(spmm: Callable, degc: torch.Tensor, config: DidicConfig):
    """One DiDiC iteration; the commit mask is an argument."""
    k = config.k
    safe_deg = torch.clamp(degc, min=1e-6)[:, None]
    degc = degc[:, None]
    classes = torch.arange(k, dtype=torch.int32, device=degc.device)

    def step(w, l, parts, beta, commit, smooth_steps: int):
        n = w.shape[0]
        onehot = (parts[:, None] == classes[None, :]).to(w.dtype)
        # Fresh per-member secondary seed with an ε-floor (JAX fix #1).
        l = _INIT_LOAD * onehot + 0.01
        benefit = 1.0 + (_BENEFIT - 1.0) * onehot  # 10 for members, else 1
        for _ in range(config.primary_steps):
            for _ in range(config.secondary_steps):
                lb = l / benefit
                l = l - degc * lb + spmm(lb)
            w = w + l - degc * w + spmm(w)
        w = w / torch.clamp(w.mean(), min=1e-6)  # column-common rescale
        # Annealed lazy-random-walk assignment smoothing (fixes #3, #4).
        smoothed = w
        for _ in range(smooth_steps):
            smoothed = 0.5 * smoothed + 0.5 * spmm(smoothed) / safe_deg
        # ScaleBalance (fix #2): fit β so argmax sizes approach N/k.
        tgt = n / k
        for _ in range(config.balance_iters):
            p = torch.argmax(smoothed * beta[None, :], dim=1)
            sizes = torch.bincount(p, minlength=k).to(w.dtype)
            beta = torch.clamp(
                beta * (tgt / torch.clamp(sizes, min=1.0)) ** config.balance_exp, 1e-3, 1e3
            )
        new_parts = torch.argmax(smoothed * beta[None, :], dim=1).to(torch.int32)
        parts = torch.where(commit, new_parts, parts)
        return w, l, parts, beta

    return step


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
) -> DidicState:
    step = _make_step(spmm, degc, config)
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
) -> Tuple[np.ndarray, DidicState]:
    """Repair/maintain an existing partitioning (paper Stress/Dynamic
    experiments): seeds loads from ``parts``, runs at full smoothing width
    and commits deterministically (``commit_prob=1``), as the JAX package
    does. ``commit_masks`` as in :func:`didic_partition`.
    """
    dev = resolve_device(device)
    config = dataclasses.replace(config, commit_prob=1.0)
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
    return state.parts.cpu().numpy(), state
