"""Generators of the paper's three evaluation graphs (paper §6.2).

Twin of ``repro.graphs.generators``: (a) a synthetic *file system* tree
(730 027 V / 1 310 041 E at ``scale=1.0``), (b) the *Romania GIS* road
network (785 891 V / 1 621 138 E, vertex density concentrated at five
cities, weighted edges = travel time), and (c) a *Twitter* crawl
(611 643 V / 851 799 E, scale-free out-degree), plus the planted
two-community graph used by the tests and the small graphs behind the GNN
and MACE shapes (a random graph, a grid, a triangulated mesh and a batch
of molecules).

The code is the same vectorized numpy as the JAX package's, draw for draw,
so for one ``(scale, seed)`` both packages build identical arrays (the
parity tests hold them to that).

Node-type codes (file system): 0=organization, 1=user, 2=folder, 3=file,
4=event.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.structure import Graph

__all__ = [
    "filesystem_tree",
    "gis_romania",
    "twitter_social",
    "two_cluster",
    "random_graph",
    "grid_graph",
    "molecule_batch",
    "mesh_graph",
    "FS_ORG", "FS_USER", "FS_FOLDER", "FS_FILE", "FS_EVENT",
]

FS_ORG, FS_USER, FS_FOLDER, FS_FILE, FS_EVENT = 0, 1, 2, 3, 4

# Five Romanian cities used by the paper's hardcoded GIS partitioner (§6.3):
# (name, longitude, latitude, relative size)
_CITIES = (
    ("bucharest", 26.10, 44.43, 0.40),
    ("iasi", 27.60, 47.16, 0.15),
    ("galati", 28.05, 45.43, 0.12),
    ("timisoara", 21.23, 45.76, 0.18),
    ("constanta", 28.63, 44.18, 0.15),
)


# --------------------------------------------------------------------------
# File system (paper §6.2.1)
# --------------------------------------------------------------------------
def filesystem_tree(
    scale: float = 0.1,
    seed: int = 0,
    n_orgs: int = 5,
    folder_fanout: int = 31,
    subfolder_fanout: int = 2,
) -> Graph:
    """Synthetic file-system graph.

    Tree of org → user → folder hierarchy where each folder has
    ``subfolder_fanout`` child folders and ``folder_fanout - subfolder_fanout``
    child files (total out-degree ≈ 30–32, matching Fig. 6.1); every file and
    folder additionally owns an *event* vertex (so events are >50 % of
    vertices, §7.4.1). Edges point parent → child and entity → event.
    """
    rng = np.random.default_rng(seed)
    target_nodes = int(730_027 * scale)

    # Depth needed so the folder tree under all users reaches the target.
    n_users = max(n_orgs * 4, int(target_nodes ** 0.33))
    # nodes per user-tree ≈ folders * (1 file-ratio + events ≈ *2.9)
    senders, receivers = [], []
    tree_s, tree_r = [], []  # tree edges only (for parent/depth attrs)
    node_type = []

    def new_nodes(n: int, t: int) -> np.ndarray:
        start = len(node_type)
        node_type.extend([t] * n)
        return np.arange(start, start + n, dtype=np.int64)

    def add_edges(s_arr, r_arr, tree: bool = False):
        senders.append(np.asarray(s_arr)); receivers.append(np.asarray(r_arr))
        if tree:
            tree_s.append(np.asarray(s_arr)); tree_r.append(np.asarray(r_arr))

    orgs = new_nodes(n_orgs, FS_ORG)
    users = new_nodes(n_users, FS_USER)
    org_of_user = rng.integers(0, n_orgs, size=n_users)
    add_edges(orgs[org_of_user], users, tree=True)

    # root folder per user
    frontier = new_nodes(n_users, FS_FOLDER)
    add_edges(users, frontier, tree=True)
    owner = np.arange(n_users)        # user index of each frontier folder
    parent_of_frontier = users.copy()  # tree parent of each frontier folder

    files_per_folder = folder_fanout - subfolder_fanout
    level = 0
    while len(node_type) < target_nodes and frontier.shape[0] > 0 and level < 12:
        # Files + their events.
        nf = frontier.shape[0]
        files = new_nodes(nf * files_per_folder, FS_FILE)
        file_parent = np.repeat(frontier, files_per_folder)
        add_edges(file_parent, files, tree=True)
        ev_f = new_nodes(files.shape[0], FS_EVENT)
        add_edges(files, ev_f, tree=True)
        # Event meta-edges (the non-tree edges of §6.2.1). Per the paper,
        # event edges associate *files or folders* with their event vertices
        # — they stay inside the subtree. A file event references the file's
        # parent folder ~15 % of the time ("event happened in folder F",
        # closing a folder→file→event triangle — this sets the clustering
        # coefficient near the paper's 0.117) and the grandparent folder
        # otherwise; ~58 % carry a second grandparent reference, bringing
        # E/V to the paper's ≈1.79.
        gp = np.repeat(parent_of_frontier, files_per_folder)
        tri = rng.random(ev_f.shape[0]) < 0.15
        add_edges(ev_f[tri], file_parent[tri])
        add_edges(ev_f[~tri], gp[~tri])
        second = rng.random(ev_f.shape[0]) < 0.58
        add_edges(ev_f[second], gp[second])
        # Folder events.
        ev_d = new_nodes(nf, FS_EVENT)
        add_edges(frontier, ev_d, tree=True)
        add_edges(ev_d, parent_of_frontier)
        if len(node_type) >= target_nodes:
            break
        # Subfolders.
        subs = new_nodes(nf * subfolder_fanout, FS_FOLDER)
        add_edges(np.repeat(frontier, subfolder_fanout), subs, tree=True)
        owner = np.repeat(owner, subfolder_fanout)
        parent_of_frontier = np.repeat(frontier, subfolder_fanout)
        frontier = subs
        level += 1

    s = np.concatenate(senders).astype(np.int32)
    r = np.concatenate(receivers).astype(np.int32)
    nt = np.array(node_type, dtype=np.int8)
    n = nt.shape[0]

    # Folder depth (for access-pattern walks up the tree), from tree edges.
    parent = np.full(n, -1, dtype=np.int64)
    ts = np.concatenate(tree_s); tr = np.concatenate(tree_r)
    parent[tr] = ts
    depth = np.zeros(n, dtype=np.int16)
    # Iterate: depth(root orgs)=0; propagate. Tree depth <= level+4 passes.
    for _ in range(level + 6):
        has_parent = parent >= 0
        depth[has_parent] = depth[parent[has_parent]] + 1

    return Graph(
        n_nodes=n,
        senders=s,
        receivers=r,
        edge_weight=np.ones(s.shape[0], dtype=np.float32),
        node_attrs={"node_type": nt, "depth": depth, "parent": parent.astype(np.int64)},
        name="filesystem",
    )


# --------------------------------------------------------------------------
# GIS (paper §6.2.2)
# --------------------------------------------------------------------------
def gis_romania(scale: float = 0.1, seed: int = 0, city_fraction: float = 0.62) -> Graph:
    """Synthetic Romania road network.

    Vertices are geographic points: ``city_fraction`` cluster around the five
    cities (Gaussian blobs), the rest are rural — placed along inter-city
    highway corridors plus uniform background (lon ∈ [20,30]). Edges connect
    spatial near-neighbors via a grid-bucket kNN (k higher inside cities, so
    city clustering coefficient exceeds rural — §6.2.2), with weight =
    Euclidean distance (travel time).
    """
    rng = np.random.default_rng(seed)
    n = int(785_891 * scale)

    sizes = np.array([c[3] for c in _CITIES])
    cxy = np.array([[c[1], c[2]] for c in _CITIES])
    n_city = int(n * city_fraction)
    n_rural = n - n_city
    city_of = rng.choice(len(_CITIES), size=n_city, p=sizes / sizes.sum())
    city_pts = cxy[city_of] + rng.normal(0.0, 0.08, size=(n_city, 2))

    # Highways: points interpolated between random city pairs with jitter.
    n_hw = n_rural // 2
    a = rng.integers(0, len(_CITIES), size=n_hw)
    b = (a + 1 + rng.integers(0, len(_CITIES) - 1, size=n_hw)) % len(_CITIES)
    t = rng.random(n_hw)[:, None]
    hw_pts = cxy[a] * (1 - t) + cxy[b] * t + rng.normal(0, 0.05, size=(n_hw, 2))
    bg_pts = np.stack(
        [rng.uniform(20.0, 30.0, n_rural - n_hw), rng.uniform(43.5, 48.2, n_rural - n_hw)], axis=1
    )
    xy = np.concatenate([city_pts, hw_pts, bg_pts], axis=0)
    is_city = np.zeros(n, dtype=bool)
    is_city[:n_city] = True

    # Grid-bucket kNN: hash points to cells; connect each point to its
    # nearest few neighbors inside a 3x3 cell neighborhood.
    cell = 0.05
    gx = np.floor((xy[:, 0] - 19.5) / cell).astype(np.int64)
    gy = np.floor((xy[:, 1] - 43.0) / cell).astype(np.int64)
    ncols = int(gx.max()) + 2
    cell_id = gy * ncols + gx
    order = np.argsort(cell_id, kind="stable")
    sorted_cells = cell_id[order]

    ks = np.where(is_city, 3, 2)  # out-links per node
    senders, receivers, weights = [], [], []
    # For each of the 9 neighbor-cell offsets, pair each point with a few
    # points of the shifted cell via searchsorted windows.
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            tgt_cell = (gy + dy) * ncols + (gx + dx)
            lo = np.searchsorted(sorted_cells, tgt_cell, side="left")
            hi = np.searchsorted(sorted_cells, tgt_cell, side="right")
            width = hi - lo
            has = width > 0
            if not has.any():
                continue
            # sample up to 1 candidate per offset (keeps E ≈ 2n, paper ratio)
            pick = lo + (rng.integers(0, 1 << 30, size=n) % np.maximum(width, 1))
            cand = order[np.minimum(pick, order.shape[0] - 1)]
            ok = has & (cand != np.arange(n))
            src = np.nonzero(ok)[0]
            dst = cand[ok]
            d = np.linalg.norm(xy[src] - xy[dst], axis=1).astype(np.float32)
            keep = d < 0.15  # only local roads
            senders.append(src[keep]); receivers.append(dst[keep]); weights.append(d[keep])

    s = np.concatenate(senders)
    r = np.concatenate(receivers)
    w = np.concatenate(weights)
    # Keep roughly ks out-edges per node: sort by (src, dist), take first ks.
    order2 = np.lexsort((w, s))
    s, r, w = s[order2], r[order2], w[order2]
    rank = np.zeros(s.shape[0], dtype=np.int64)
    if s.shape[0]:
        newrow = np.concatenate([[True], s[1:] != s[:-1]])
        idx = np.arange(s.shape[0])
        row_start = np.maximum.accumulate(np.where(newrow, idx, 0))
        rank = idx - row_start
    keep = rank < ks[s]
    s, r, w = s[keep], r[keep], w[keep]

    # Chain highway points so the skeleton is connected.
    hw_idx = np.arange(n_city, n_city + n_hw)
    if n_hw > 1:
        hw_order = hw_idx[np.argsort(a * 10 + t[:, 0])]
        cs, cr = hw_order[:-1], hw_order[1:]
        cd = np.linalg.norm(xy[cs] - xy[cr], axis=1).astype(np.float32)
        ok = cd < 1.0
        s = np.concatenate([s, cs[ok]])
        r = np.concatenate([r, cr[ok]])
        w = np.concatenate([w, cd[ok]])

    w = np.maximum(w, 1e-4).astype(np.float32)
    return Graph(
        n_nodes=n,
        senders=s.astype(np.int32),
        receivers=r.astype(np.int32),
        edge_weight=w,
        node_attrs={
            "lon": xy[:, 0].astype(np.float32),
            "lat": xy[:, 1].astype(np.float32),
            "is_city": is_city,
            "city_id": np.concatenate(
                [city_of, np.full(n_rural, -1, dtype=np.int64)]
            ).astype(np.int16),
        },
        name="gis",
    )


# --------------------------------------------------------------------------
# Twitter (paper §6.2.3)
# --------------------------------------------------------------------------
def twitter_social(scale: float = 0.1, seed: int = 0) -> Graph:
    """Scale-free "follows" graph via vectorized preferential attachment.

    Matches the paper's |E|/|V| ≈ 1.39 and exponential-tail degree
    distribution (Fig. 6.8): each new user follows ``Geometric(p)`` existing
    users; targets are drawn preferentially by in-degree using the standard
    repeated-edge-endpoint trick (sampling uniformly from prior edge
    endpoints ≈ degree-proportional sampling).
    """
    rng = np.random.default_rng(seed)
    n = int(611_643 * scale)
    avg_out = 851_799 / 611_643
    n_seed = 8
    # out-degree per new node: geometric with mean avg_out (>=0), capped.
    p = 1.0 / (1.0 + avg_out)
    outs = np.minimum(rng.geometric(p, size=n) - 1, 64)
    outs[:n_seed] = 0
    total_e = int(outs.sum())

    senders = np.repeat(np.arange(n, dtype=np.int64), outs)
    receivers = np.empty(total_e, dtype=np.int64)
    # Vectorized chunked preferential attachment: process nodes in chunks,
    # sampling targets from the endpoint pool built so far.
    pool = list(rng.integers(0, n_seed, size=16))
    pos = 0
    chunk = max(1024, n // 256)
    pool_arr = np.array(pool, dtype=np.int64)
    pool_len = pool_arr.shape[0]
    cap = max(total_e * 2 + 32, 1024)
    buf = np.empty(cap, dtype=np.int64)
    buf[:pool_len] = pool_arr
    for start in range(n_seed, n, chunk):
        stop = min(start + chunk, n)
        m = int(outs[start:stop].sum())
        if m == 0:
            continue
        # mix preferential (from buf) with uniform-random for tail mass
        pref = rng.random(m) < 0.75
        tgt = np.where(
            pref,
            buf[rng.integers(0, max(pool_len, 1), size=m)],
            rng.integers(0, stop, size=m),
        )
        receivers[pos:pos + m] = tgt
        buf[pool_len:pool_len + m] = tgt
        pool_len += m
        pos += m
    receivers = receivers[:pos]
    senders = senders[:pos]
    keep = senders != receivers
    return Graph(
        n_nodes=n,
        senders=senders[keep].astype(np.int32),
        receivers=receivers[keep].astype(np.int32),
        edge_weight=np.ones(int(keep.sum()), dtype=np.float32),
        node_attrs={},
        name="twitter",
    )


# --------------------------------------------------------------------------
# Small graphs for tests / GNN shapes
# --------------------------------------------------------------------------
def two_cluster(n_per: int = 64, p_in: float = 0.3, p_out: float = 0.01, seed: int = 0) -> Graph:
    """Planted 2-community graph — DiDiC must recover the communities."""
    rng = np.random.default_rng(seed)
    n = 2 * n_per
    block = (np.arange(n) >= n_per).astype(np.int64)
    iu = np.triu_indices(n, k=1)
    same = block[iu[0]] == block[iu[1]]
    prob = np.where(same, p_in, p_out)
    keep = rng.random(iu[0].shape[0]) < prob
    s, r = iu[0][keep], iu[1][keep]
    return Graph(
        n_nodes=n, senders=s.astype(np.int32), receivers=r.astype(np.int32),
        edge_weight=np.ones(s.shape[0], dtype=np.float32),
        node_attrs={"block": block}, name="two_cluster",
    )


def random_graph(n: int, avg_degree: float = 4.0, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    e = int(n * avg_degree / 2)
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n, size=e)
    keep = s != r
    return Graph(
        n_nodes=n, senders=s[keep].astype(np.int32), receivers=r[keep].astype(np.int32),
        edge_weight=np.ones(int(keep.sum()), dtype=np.float32), name="random",
    )


def grid_graph(rows: int, cols: int) -> Graph:
    idx = np.arange(rows * cols).reshape(rows, cols)
    s = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    r = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return Graph(
        n_nodes=rows * cols, senders=s.astype(np.int32), receivers=r.astype(np.int32),
        edge_weight=np.ones(s.shape[0], dtype=np.float32), name="grid",
    )


def molecule_batch(
    n_mols: int = 128, atoms_per_mol: int = 30, edges_per_mol: int = 64, seed: int = 0,
    cutoff: float = 1.6,
) -> Graph:
    """Batched small molecules: random 3D point clouds with radius edges,
    one disjoint-union graph (the MACE ``molecule`` shape: 30 atoms, ~64
    edges, 128 molecules). ``node_attrs`` holds ``pos``, ``species`` and
    ``mol_id``."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 1.0, size=(n_mols, atoms_per_mol, 3)).astype(np.float32)
    species = rng.integers(0, 4, size=(n_mols, atoms_per_mol))
    senders, receivers = [], []
    d = np.linalg.norm(pos[:, :, None, :] - pos[:, None, :, :], axis=-1)
    np.einsum("mii->mi", d)[:] = np.inf
    for m in range(n_mols):
        sm, rm = np.nonzero(d[m] < cutoff)
        if sm.shape[0] > edges_per_mol * 2:
            sel = np.argsort(d[m][sm, rm])[: edges_per_mol * 2]
            sm, rm = sm[sel], rm[sel]
        senders.append(sm + m * atoms_per_mol)
        receivers.append(rm + m * atoms_per_mol)
    s = np.concatenate(senders)
    r = np.concatenate(receivers)
    return Graph(
        n_nodes=n_mols * atoms_per_mol,
        senders=s.astype(np.int32), receivers=r.astype(np.int32),
        edge_weight=np.ones(s.shape[0], dtype=np.float32),
        node_attrs={
            "pos": pos.reshape(-1, 3),
            "species": species.reshape(-1).astype(np.int32),
            "mol_id": np.repeat(np.arange(n_mols), atoms_per_mol).astype(np.int32),
        },
        name="molecules",
    )


def mesh_graph(rows: int, cols: int, seed: int = 0) -> Graph:
    """Triangulated 2D simulation mesh (MeshGraphNet's graphs)."""
    g = grid_graph(rows, cols)
    idx = np.arange(rows * cols).reshape(rows, cols)
    s = np.concatenate([g.senders, idx[:-1, :-1].ravel().astype(np.int32)])
    r = np.concatenate([g.receivers, idx[1:, 1:].ravel().astype(np.int32)])
    rng = np.random.default_rng(seed)
    xy = np.stack(np.meshgrid(np.arange(cols), np.arange(rows)), -1).reshape(-1, 2)
    return Graph(
        n_nodes=rows * cols, senders=s, receivers=r,
        edge_weight=np.ones(s.shape[0], dtype=np.float32),
        node_attrs={"pos": xy.astype(np.float32) + rng.normal(0, 0.05, xy.shape).astype(np.float32)},
        name="mesh",
    )
