"""DiDiC-driven expert placement for MoE (twin of ``repro.distributed.expert_placement``).

Token→expert routing induces a dynamic bipartite access graph; experts
that co-activate on the same tokens benefit from living on the same
device group (a top-k token whose experts straddle devices pays
cross-device combine latency).

This is the paper's Runtime-Logging → Runtime-Partitioning → Migration
loop applied to experts:

* Runtime-Logging — the expert co-activation graph from router top-k
  outputs (edge weight = #tokens choosing both experts),
* Runtime-Partitioning — DiDiC partitions it into ``n_groups`` groups,
* Migration-Scheduler — the resulting permutation re-orders the expert
  stacks.

``co_location_fraction`` is the quality metric: the fraction of top-k
pairs served within one group (the MoE analogue of the paper's T_G %).
Host numpy, with the port's DiDiC on ``device`` (default CUDA); the arrays
are built as the JAX package builds them, so both give the same graph and
the same permutation for the same groups.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.didic import DidicConfig, didic_partition
from repro_torch.graphs.structure import Graph

__all__ = [
    "coactivation_graph",
    "didic_expert_groups",
    "co_location_fraction",
    "expert_permutation",
]


def coactivation_graph(expert_idx: np.ndarray, n_experts: int) -> Graph:
    """``expert_idx [N_tokens, k]`` → weighted undirected graph over experts
    where w(e1, e2) = number of tokens routed to both (one unit edge per
    token and pair, pairs ``(i, j)``, ``i < j``, in order)."""
    _, k = expert_idx.shape
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
    s = np.concatenate([expert_idx[:, i] for i, _ in pairs])
    r = np.concatenate([expert_idx[:, j] for _, j in pairs])
    keep = s != r
    return Graph(
        n_nodes=n_experts,
        senders=s[keep].astype(np.int32),
        receivers=r[keep].astype(np.int32),
        edge_weight=np.ones(int(keep.sum()), np.float32),
        name="expert_coactivation",
    )


def didic_expert_groups(
    graph: Graph, n_groups: int, iterations: int = 40, seed: int = 0, device=None,
) -> np.ndarray:
    """Partition experts into device groups with DiDiC."""
    cfg = DidicConfig(k=n_groups, iterations=iterations, smooth_cap=16)
    parts, _ = didic_partition(graph, cfg, seed=seed, device=device)
    return parts


def co_location_fraction(expert_idx: np.ndarray, groups: np.ndarray) -> float:
    """Fraction of (token, expert-pair) co-activations inside one group."""
    n, k = expert_idx.shape
    g = groups[expert_idx]  # [N, k]
    total, inside = 0, 0
    for i in range(k):
        for j in range(i + 1, k):
            total += n
            inside += int((g[:, i] == g[:, j]).sum())
    return inside / max(total, 1)


def expert_permutation(groups: np.ndarray, n_groups: int) -> np.ndarray:
    """Expert order such that each device group holds contiguous experts.

    Groups are balanced by folding overflow into the under-filled groups
    (DiDiC's groups may be uneven; the layout needs exactly E/n_groups each).
    """
    e = groups.shape[0]
    per = e // n_groups
    buckets = [list(np.nonzero(groups == g)[0]) for g in range(n_groups)]
    overflow = []
    for b in buckets:
        while len(b) > per:
            overflow.append(b.pop())
    for b in buckets:
        while len(b) < per and overflow:
            b.append(overflow.pop())
    perm = np.concatenate([np.array(b, dtype=np.int64) for b in buckets])
    if perm.shape[0] != e:
        raise ValueError(f"{e} experts do not split into {n_groups} groups of {per}")
    return perm
