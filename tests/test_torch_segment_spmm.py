"""The port's fixed-order CSR product (``repro_torch.kernels.segment_spmm``)
on the CPU, and DiDiC's diffusion product routed through it.

Held, all bit for bit (the CPU's sums are the card kernel's contract):

* the plain version equals ``jax.ops.segment_sum`` of the same float32
  products ``ce[:, None] * x[r]``, and the JAX package's own jitted
  product (``repro.core.didic._spmm_segment``), on DiDiC's coefficient
  matrices of filesystem, GIS and Twitter at ``scale=0.003``, k = 2, 4, 8;
* it equals a numpy loop that adds each row's rounded products in
  ascending edge order, on rows around a 50,000-edge hub, at F = 1, 4, 33;
* the CSR grouping (offsets, the long rows longest first) equals numpy's
  ``bincount``/``cumsum`` and a stable sort, with empty rows inside and
  past the last sender, also for the capacity overlay's ``n_cap + 1`` rows;
* ``SegmentSpmm`` (both of DiDiC's uses: ``make_spmm``'s segment route and
  the overlay tables) equals the plain version, the overlay's dead rows
  exactly 0;
* the three epilogues (DiDiC's secondary, primary and smoothing updates
  fused with their product) equal the step's eager expressions around the
  bare product, on DiDiC's matrices at F 1-33 and on the overlay with its
  dead rows;
* the tile plan covers every short row once, in order, within its edge and
  row budgets, and holds no long row;
* no CPU call launches a kernel, and a CUDA request without a card raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.didic import _spmm_segment as jax_spmm_segment
from repro_torch import kernels
from repro_torch.core import didic
from repro_torch.graphs import datasets
from repro_torch.kernels.segment_spmm import (
    csr_matrix, segment_spmm, segment_spmm_primary, segment_spmm_ref, segment_spmm_secondary, segment_spmm_smooth,
    tile_plan,
)
from repro_torch.kernels.segment_spmm import ops as spmm_ops

torch.set_num_threads(1)


def _bits(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float32).view(np.int32)


def _spread(rng, shape) -> np.ndarray:
    """float32 values over many binades, so that another order rounds otherwise."""
    return (rng.standard_normal(shape) * np.exp(3 * rng.standard_normal(shape[:1] + (1,) * (len(shape) - 1)))
            ).astype(np.float32)


def _numpy_grouping(ids, n, long_at):
    counts = np.bincount(ids, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    long_rows = np.nonzero(counts > long_at)[0]
    return offsets, long_rows[np.argsort(-counts[long_rows], kind="stable")]


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("name", ["filesystem", "gis", "twitter"])
def test_plain_version_equals_jax_segment_sum_on_didic_matrices(name, k):
    g = datasets.load(name, scale=0.003)
    s, r, ce, _ = didic._edge_coefficients(g)
    x = _spread(np.random.default_rng(k), (g.n_nodes, k))
    a = csr_matrix(torch.as_tensor(s), torch.as_tensor(r), torch.as_tensor(ce), g.n_nodes)
    got = segment_spmm(torch.as_tensor(x), a).numpy()
    products = ce[:, None] * x[r]
    want = jax.ops.segment_sum(jnp.asarray(products), jnp.asarray(s), num_segments=g.n_nodes)
    assert np.array_equal(_bits(got), _bits(want))
    spmm = jax.jit(lambda v: jax_spmm_segment(jnp.asarray(ce), jnp.asarray(s), jnp.asarray(r), g.n_nodes, v))
    assert np.array_equal(_bits(got), _bits(spmm(jnp.asarray(x))))


@pytest.mark.parametrize("f", [1, 4, 33])
def test_plain_version_is_the_edge_order_loop_around_a_hub(f):
    rng = np.random.default_rng(f)
    n_x, hub = 700, 50_000
    at = spmm_ops.LONG_SEGMENT
    lengths = np.array([3, 0, hub, 1, at + 1, 0, at, at - 1, 0])  # empty rows, both sides of LONG_SEGMENT
    ids = np.repeat(np.arange(lengths.size), lengths)
    col = rng.integers(0, n_x, ids.size).astype(np.int32)
    scale = _spread(rng, (ids.size,))
    x = _spread(rng, (n_x, f))
    n = lengths.size + 2                                          # two empty rows past the last edge
    a = csr_matrix(torch.as_tensor(ids), torch.as_tensor(col), torch.as_tensor(scale), n)
    got = segment_spmm(torch.as_tensor(x), a).numpy()
    loop = np.zeros((n, f), np.float32)
    for e in range(ids.size):                                     # the kernel's order: ascending edge id a row
        loop[ids[e]] += scale[e] * x[col[e]]
    assert np.array_equal(_bits(got), _bits(loop))
    assert not got[lengths.size:].any() and not got[:lengths.size][lengths == 0].any()


@pytest.mark.parametrize("n_extra", [0, 1, 37])
def test_grouping_equals_numpy(n_extra):
    rng = np.random.default_rng(n_extra)
    lengths = rng.integers(0, 3, 400)
    at = spmm_ops.LONG_SEGMENT
    lengths[[5, 90, 91, 300]] = [at + 1, at + 100, at + 1, at]      # long rows, a tie, one at the threshold
    ids = np.repeat(np.arange(400), lengths)
    n = 400 + n_extra
    col = rng.integers(0, 50, ids.size)
    a = csr_matrix(torch.as_tensor(ids), torch.as_tensor(col), torch.as_tensor(col * 0.5), n)
    offsets, long_rows = _numpy_grouping(ids, n, spmm_ops.LONG_SEGMENT)
    assert a.n == n and a.long_at == spmm_ops.LONG_SEGMENT
    assert np.array_equal(a.offsets.numpy(), offsets)
    assert np.array_equal(a.long_ids.numpy(), long_rows)
    assert long_rows.tolist() == [90, 5, 91]
    assert np.array_equal(a.ids.numpy(), ids)
    assert a.col.dtype == torch.int32 and np.array_equal(a.col.numpy(), col)
    assert a.scale.dtype == torch.float32 and np.array_equal(a.scale.numpy(), (col * 0.5).astype(np.float32))


def test_grouping_rejects_unsorted_or_outside_rows_and_ragged_edges():
    for ids, n in (([0, 2, 1], 3), ([0, 1, 3], 3), ([-1, 0], 2)):
        with pytest.raises(ValueError, match="ascending"):
            csr_matrix(torch.tensor(ids), torch.zeros(len(ids)), torch.zeros(len(ids)), n)
    with pytest.raises(ValueError, match="2 row ids, 3 columns"):
        csr_matrix(torch.tensor([0, 1]), torch.zeros(3), torch.zeros(2), 2)
    empty = csr_matrix(torch.zeros(0, dtype=torch.int64), torch.zeros(0), torch.zeros(0), 4)
    assert empty.offsets.tolist() == [0] * 5 and empty.long_ids.numel() == 0
    assert not segment_spmm(torch.rand(3, 2), empty).any()


@pytest.mark.parametrize("name", ["filesystem", "gis", "twitter"])
def test_segment_spmm_class_equals_the_plain_version(name):
    g = datasets.load(name, scale=0.003)
    s, r, ce, _ = didic._edge_coefficients(g)
    spmm, _ = didic.make_spmm(g, didic.DidicConfig(k=4), device="cpu")
    assert isinstance(spmm, didic.SegmentSpmm)
    x = torch.as_tensor(_spread(np.random.default_rng(0), (g.n_nodes, 4)))
    want = segment_spmm_ref(x, torch.as_tensor(r), torch.as_tensor(ce), torch.as_tensor(s).long(), g.n_nodes)
    assert np.array_equal(_bits(spmm(x)), _bits(want))
    assert spmm.a.col.dtype == torch.int32 and spmm.a.scale.dtype == torch.float32


@pytest.mark.parametrize("name", ["filesystem", "twitter"])
def test_overlay_product_keeps_dead_rows_zero(name):
    g = datasets.load(name, scale=0.003)
    store = g.ensure_store(headroom=1.5)
    spmm, degc = didic._overlay_tables(g, "cpu")
    n, n_rows = g.n_nodes, store.n_cap + 1
    s, r, ce, _ = didic._edge_coefficients(g)
    offsets, long_rows = _numpy_grouping(s, n_rows, spmm_ops.LONG_SEGMENT)
    assert spmm.a.n == n_rows > n
    assert np.array_equal(spmm.a.offsets.numpy(), offsets)
    assert np.array_equal(spmm.a.long_ids.numpy(), long_rows)
    x = torch.as_tensor(_spread(np.random.default_rng(1), (n_rows, 4)))   # live values in the dead rows too
    got = spmm(x)
    assert got.shape == (n_rows, 4) and not got[n:].any() and not degc[n:].any()
    want = didic.make_spmm(g, didic.DidicConfig(k=4), device="cpu")[0](x[:n])
    assert np.array_equal(_bits(got[:n]), _bits(want))


def test_cpu_tensors_never_launch_and_cuda_request_raises(monkeypatch):
    kernels.reset_launch_counts()
    g = datasets.load("twitter", scale=0.003)
    parts, _ = didic.didic_partition(g, didic.DidicConfig(k=4, iterations=2), seed=0, device="cpu")
    assert parts.shape == (g.n_nodes,)
    a = csr_matrix(torch.tensor([0, 0, 2]), torch.tensor([4, 0, 1]), torch.rand(3), 3)
    meta = segment_spmm(torch.empty(5, 4, device="meta"), a._replace(
        ids=a.ids.to("meta"), col=a.col.to("meta"), scale=a.scale.to("meta")))
    assert meta.device.type == "meta" and meta.shape == (3, 4)
    assert all(n == 0 for n in kernels.launch_counts().values())

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        didic.make_spmm(g, didic.DidicConfig(k=4, iterations=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        didic.didic_partition(g, didic.DidicConfig(k=4, iterations=2), seed=0)


def _eager_updates(spmm, x, l, degc, parts, live=None):
    """DiDiC's three updates as the step writes them, around the bare
    product ``spmm`` (``core/didic.py``'s ``_make_step``)."""
    k = x.shape[1]
    onehot = (parts[:, None] == torch.arange(k, dtype=torch.int32)[None, :]).to(torch.float32)
    if live is not None:
        onehot = onehot * live.to(torch.float32)[:, None]
    benefit = 1.0 + (didic._BENEFIT - 1.0) * onehot
    safe_deg = torch.clamp(degc, min=1e-6)[:, None]
    lb = l / benefit
    l2 = l - degc[:, None] * lb + spmm(lb)
    return {
        "secondary": (l2, l2 / benefit),
        "primary": x + l - degc[:, None] * x + spmm(x),
        "smooth": 0.5 * x + 0.5 * spmm(x) / safe_deg,
        "lb": lb,
    }


def _fused_updates(a, x, l, degc, parts, lb, live=None):
    return {
        "secondary": segment_spmm_secondary(lb, a, l, degc, parts, didic._BENEFIT, live),
        "primary": segment_spmm_primary(x, a, l, degc),
        "smooth": segment_spmm_smooth(x, a, torch.clamp(degc, min=1e-6)),
    }


def _assert_updates_equal(got, want):
    for name in ("primary", "smooth"):
        assert np.array_equal(_bits(got[name]), _bits(want[name])), name
    for i, part in enumerate(("l", "lb")):
        assert np.array_equal(_bits(got["secondary"][i]), _bits(want["secondary"][i])), part


@pytest.mark.parametrize("f", [1, 3, 4, 8, 33])
@pytest.mark.parametrize("name", ["filesystem", "gis", "twitter"])
def test_epilogues_equal_the_eager_expressions(name, f):
    g = datasets.load(name, scale=0.003)
    s, r, ce, degc = didic._edge_coefficients(g)
    a = csr_matrix(torch.as_tensor(s), torch.as_tensor(r), torch.as_tensor(ce), g.n_nodes)
    rng = np.random.default_rng(10 + f)
    x, l = (torch.as_tensor(_spread(rng, (g.n_nodes, f))) for _ in range(2))
    parts = torch.as_tensor(rng.integers(0, f, g.n_nodes).astype(np.int32))
    degc = torch.as_tensor(degc)
    want = _eager_updates(lambda v: segment_spmm(v, a), x, l, degc, parts)
    _assert_updates_equal(_fused_updates(a, x, l, degc, parts, want["lb"]), want)


@pytest.mark.parametrize("name", ["filesystem", "twitter"])
def test_epilogues_on_the_overlay_keep_dead_rows_zero(name):
    g = datasets.load(name, scale=0.003)
    g.ensure_store(headroom=1.5)
    spmm, degc = didic._overlay_tables(g, "cpu")
    n_rows, n = spmm.a.n, g.n_nodes
    live = torch.arange(n_rows) < n
    rng = np.random.default_rng(2)
    x, l = (torch.as_tensor(_spread(rng, (n_rows, 4))) * live[:, None] for _ in range(2))
    parts = torch.as_tensor(rng.integers(0, 4, n_rows).astype(np.int32))
    want = _eager_updates(spmm, x, l, degc, parts, live)
    got = _fused_updates(spmm.a, x, l, degc, parts, want["lb"], live)
    _assert_updates_equal(got, want)
    for t in (got["primary"], got["smooth"], *got["secondary"]):
        assert not t[n:].any()


def _check_plan(offsets, tiles, long_at, max_edges, max_rows):
    """Every row of at most ``long_at`` edges in exactly one tile, the tiles
    in row order, each a run of short rows within both budgets."""
    lengths = np.diff(offsets)
    covered = np.concatenate([np.arange(t0, t1) for t0, t1, _, _ in tiles]) if len(tiles) else np.zeros(0, int)
    assert np.array_equal(covered, np.flatnonzero(lengths <= long_at))   # once each, ascending
    assert (tiles[:, 1] > tiles[:, 0]).all() and (tiles[:, 1] - tiles[:, 0] <= max_rows).all()
    assert np.array_equal(tiles[:, 2], offsets[tiles[:, 0]]) and np.array_equal(tiles[:, 3], offsets[tiles[:, 1]])
    assert (tiles[:, 3] - tiles[:, 2] <= max_edges).all()


@pytest.mark.parametrize("max_edges,max_rows", [(2048, 256), (64, 256), (40, 3)])
def test_tile_plan_covers_every_short_row_once(max_edges, max_rows):
    at = 20
    # empty rows at both ends and inside, a row of exactly long_at edges,
    # a short row alone between two long rows (a single-row tile), long rows
    # back to back, and runs of short rows
    lengths = np.array([0, 0, 3, at, at + 1, 5, at + 7, at + 1, 0, 1, 2, at, at, 0, 0] + [2] * 300 + [0, 0])
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    tiles = tile_plan(offsets, at, max_edges, max_rows)
    _check_plan(offsets, tiles, at, max_edges, max_rows)
    assert [5, 6] in tiles[:, :2].tolist()          # the single-row tile
    assert not tiles.size or tiles[0, 0] == 0


@pytest.mark.parametrize("name", ["filesystem", "gis", "twitter"])
def test_tile_plan_on_didic_matrices(name):
    g = datasets.load(name, scale=0.003)
    s, r, ce, _ = didic._edge_coefficients(g)
    a = csr_matrix(torch.as_tensor(s), torch.as_tensor(r), torch.as_tensor(ce), g.n_nodes)
    offsets = a.offsets.numpy().astype(np.int64)
    tiles = a.tiles.numpy()
    _check_plan(offsets, tiles, a.long_at, spmm_ops.TILE_EDGES, spmm_ops.TILE_ROWS)
    assert a.tile_edges == (tiles[:, 3] - tiles[:, 2]).max() and a.offsets.dtype == torch.int32
    assert np.array_equal(np.setdiff1d(np.arange(g.n_nodes), np.concatenate([np.arange(t0, t1) for t0, t1, _, _ in tiles])),
                          np.sort(a.long_ids.numpy()))


def test_tile_plan_edge_cases():
    assert tile_plan(np.zeros(1, np.int64), 4).shape == (0, 4)                 # no rows
    assert tile_plan(np.array([0, 9]), 4).shape == (0, 4)                      # one long row only
    assert tile_plan(np.zeros(4, np.int64), 4).tolist() == [[0, 3, 0, 0]]      # empty rows only
    assert tile_plan(np.array([0, 4, 8]), 4, max_edges=4).tolist() == [[0, 1, 0, 4], [1, 2, 4, 8]]
    with pytest.raises(ValueError, match="would not fit"):
        tile_plan(np.array([0, 1]), 9, max_edges=8)
