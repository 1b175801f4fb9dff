"""The port's fixed-order segment sum (``repro_torch.kernels.segment_sum``)
on the CPU, and the float sums of the graph side routed through it.

Held, all bit for bit (the CPU's sums are the card kernel's contract):

* the plain version equals ``index_add_`` into zeros, a float32 loop that
  adds each segment's rows in ascending edge order (the kernel's order),
  and ``jax.ops.segment_sum`` on the same numpy inputs, over unsorted ids,
  repeats, empty segments and F = 1, 4, 16;
* the gather's backward equals autograd's own ``x[ids]`` backward, and the
  segment sum's backward equals autograd's ``index_add`` backward;
* the kernel's grouping (``segment_order``) equals a numpy stable argsort
  and ``bincount`` offsets, and is kept on the index tensor;
* an inventory of the aten ops dispatched in the forward and backward of
  the GCN, sampled GraphSAGE, MeshGraphNet and MACE losses, the halo SpMM
  on a one-rank gloo mesh and one mesh DiDiC iteration: every float
  ``index_add``, accumulating ``index_put``, ``scatter_add`` and
  ``scatter_reduce`` on those paths runs inside the segment sum's plain
  version, the one the card replaces by its kernel.
"""

from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import segment_sum as seg_pkg
from repro_torch.kernels.segment_sum import gather, segment_order, segment_sum
from repro_torch.kernels.segment_sum import ops as seg_ops
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

torch.set_num_threads(1)

# (E, n, F): unsorted ids with repeats; n > max id leaves empty segments.
CASES = [(1, 1, 1), (40, 7, 1), (300, 50, 4), (257, 19, 16), (64, 200, 4)]


def _inputs(e, n, f, seed):
    rng = np.random.default_rng(seed)
    # magnitudes spread over many binades, so another order rounds otherwise
    data = (rng.standard_normal((e, f)) * np.exp(3 * rng.standard_normal((e, 1)))).astype(np.float32)
    ids = rng.integers(0, max(n // 2, 1), size=e)          # the upper half of the segments stays empty
    return data, ids


def _bits(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("e,n,f", CASES)
def test_plain_version_is_index_add_in_edge_order_and_jax_segment_sum(e, n, f):
    data, ids = _inputs(e, n, f, seed=e + n + f)
    got = segment_sum(torch.as_tensor(data), torch.as_tensor(ids), n).numpy()
    want = torch.zeros(n, f).index_add_(0, torch.as_tensor(ids), torch.as_tensor(data)).numpy()
    loop = np.zeros((n, f), np.float32)
    for i in range(e):                      # the kernel's order: ascending edge id a segment
        loop[ids[i]] += data[i]
    jax_sum = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=n))
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got), _bits(loop))
    assert np.array_equal(_bits(got), _bits(jax_sum))
    assert not got[max(n // 2, 1):].any()                   # empty segments are 0


def test_plain_version_takes_1d_int32_and_multi_axis_data():
    data, ids = _inputs(90, 12, 6, seed=3)
    ids32 = torch.as_tensor(ids, dtype=torch.int32)
    flat = segment_sum(torch.as_tensor(data[:, 0]), ids32, 12)
    assert flat.shape == (12,)
    assert np.array_equal(_bits(flat), _bits(segment_sum_ref(torch.as_tensor(data[:, 0]), ids32.long(), 12)))
    cube = torch.as_tensor(data.reshape(90, 2, 3))
    got = segment_sum(cube, ids32, 12)
    assert got.shape == (12, 2, 3)
    assert np.array_equal(_bits(got.reshape(12, 6)), _bits(segment_sum(torch.as_tensor(data), ids32, 12)))
    meta = segment_sum(torch.empty(90, 2, 3, device="meta"), torch.empty(90, dtype=torch.int64, device="meta"), 12)
    assert meta.device.type == "meta" and meta.shape == (12, 2, 3)


@pytest.mark.parametrize("shape", [(300,), (40, 15), (20_000,)])
@pytest.mark.parametrize("f", [1, 4, 16])
def test_gather_backward_equals_autograd_index_backward(shape, f):
    """On one thread (this module's): autograd's accumulating ``index_put``
    then adds in index order too."""
    rng = np.random.default_rng(f)
    x = torch.as_tensor(rng.standard_normal((23, f)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, 20, size=shape))
    g = torch.as_tensor((rng.standard_normal(shape + (f,)) * np.exp(3 * rng.standard_normal(shape + (1,))))
                        .astype(np.float32))
    a = x.clone().requires_grad_()
    b = x.clone().requires_grad_()
    out = gather(a, ids)
    assert np.array_equal(_bits(out.detach()), _bits(b[ids].detach()))
    (ga,) = torch.autograd.grad(out, a, g)
    (gb,) = torch.autograd.grad(b[ids], b, g)
    assert np.array_equal(_bits(ga), _bits(gb))


def test_gather_backward_repeats_on_many_threads():
    """The plain backward adds in edge order whatever the thread count
    (autograd's own ``x[ids]`` backward does not repeat on several)."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.standard_normal((3000, 4)).astype(np.float32)).requires_grad_()
    ids = torch.as_tensor(rng.integers(0, 1500, size=20_000))
    g = torch.as_tensor((rng.standard_normal((20_000, 4)) * np.exp(3 * rng.standard_normal((20_000, 1))))
                        .astype(np.float32))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        grads = [torch.autograd.grad(gather(x, ids), x, g)[0] for _ in range(3)]
    finally:
        torch.set_num_threads(threads)
    want = torch.zeros(3000, 4).index_add_(0, ids, g)
    assert all(np.array_equal(_bits(a), _bits(want)) for a in grads)


def test_segment_sum_backward_equals_autograd_index_add_backward():
    data, ids = _inputs(120, 9, 4, seed=7)
    a = torch.as_tensor(data).requires_grad_()
    b = torch.as_tensor(data).requires_grad_()
    g = torch.as_tensor(np.random.default_rng(8).standard_normal((9, 4)).astype(np.float32))
    (ga,) = torch.autograd.grad(segment_sum(a, torch.as_tensor(ids), 9), a, g)
    (gb,) = torch.autograd.grad(torch.zeros(9, 4).index_add(0, torch.as_tensor(ids), b), b, g)
    assert np.array_equal(_bits(ga), _bits(gb))


@pytest.mark.parametrize("e,n,f", CASES)
def test_segment_order_is_a_stable_argsort_and_bincount_offsets(e, n, f):
    _, ids = _inputs(e, n, f, seed=e * n)
    ids = np.concatenate([ids, np.full(seg_ops.LONG_SEGMENT + 1, n - 1)])[::-1].copy()   # one long segment
    t = torch.as_tensor(ids)
    perm, offsets, long_ids = segment_order(t, n)
    assert perm.dtype == offsets.dtype == long_ids.dtype == torch.int64
    assert np.array_equal(perm.numpy(), np.argsort(ids, kind="stable"))
    counts = np.bincount(ids, minlength=n)
    assert np.array_equal(offsets.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    assert np.array_equal(long_ids.numpy(), np.flatnonzero(counts > seg_ops.LONG_SEGMENT))
    assert long_ids.tolist()[-1] == n - 1


def test_segment_order_is_kept_on_the_index_tensor():
    ids = torch.tensor([3, 0, 3, 1], dtype=torch.int32)
    first = segment_order(ids, 4)
    assert segment_order(ids, 4) is first                      # built once
    assert segment_order(ids, 5) is not first                  # another n
    assert segment_order(ids, 5)[1].shape == (6,)
    ids[0] = 2                                                  # changed in place: built again
    perm, offsets, long_ids = segment_order(ids, 5)
    assert perm.tolist() == [1, 3, 0, 2] and offsets.tolist() == [0, 1, 2, 3, 4, 4] and long_ids.numel() == 0
    nbrs = torch.tensor([[1, 0], [1, 1]])                       # any shape, flattened
    assert segment_order(nbrs, 2)[0].tolist() == [1, 0, 2, 3]


# ---------------------------------------------------------------------------
# the dispatch inventory
# ---------------------------------------------------------------------------
_SUMMING = {"aten::index_add", "aten::index_add_", "aten::scatter_add", "aten::scatter_add_",
            "aten::scatter_reduce", "aten::scatter_reduce_", "aten::index_reduce", "aten::index_reduce_"}
_PUTTING = {"aten::index_put", "aten::index_put_", "aten::_index_put_impl", "aten::_index_put_impl_"}


class _Inventory(TorchDispatchMode):
    """Records every float scatter-like op that sums (index_add, an
    accumulating index_put, scatter_add, scatter_reduce, index_reduce) and
    whether it ran inside the segment sum's plain version."""

    def __init__(self):
        super().__init__()
        self.inside = 0
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in _SUMMING or (name in _PUTTING and (args[3] if len(args) > 3 else kwargs.get("accumulate", False))):
            if args[0].dtype.is_floating_point:
                self.ops.append((name, self.inside > 0))
        return func(*args, **kwargs)


@pytest.fixture
def inventory(monkeypatch):
    inv = _Inventory()

    def plain(data, ids, n):
        inv.inside += 1
        try:
            return segment_sum_ref(data, ids, n)
        finally:
            inv.inside -= 1

    monkeypatch.setattr(seg_ops, "segment_sum_ref", plain)
    return inv


def _forward_backward(inv, loss_fn, params):
    leaves = [p for p in params if p.requires_grad]
    with inv:
        loss = loss_fn()
        torch.autograd.grad(loss, leaves, allow_unused=True)   # MACE's last mix_v, mix_t: unused
    return inv.ops


def _graph(n, e, seed):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    return torch.as_tensor(np.concatenate([s, r]), dtype=torch.int32), torch.as_tensor(np.concatenate([r, s]),
                                                                                       dtype=torch.int32)


def _assert_routed(ops):
    assert ops, "the path summed nothing through the segment sum"
    stray = [name for name, inside in ops if not inside]
    assert not stray, f"float sums outside the segment sum's plain version: {stray}"


def test_inventory_sees_autograd_and_index_add_sums(inventory):
    """The instrument itself: autograd's own ``x[ids]`` backward, a
    ``torch.gather`` backward and a bare ``index_add`` are recorded as
    outside the plain version; the segment sum's are inside."""
    x = torch.rand(5, 2, requires_grad=True)
    ids = torch.tensor([0, 3, 3])
    ops = _forward_backward(inventory, lambda: (x[ids].sum() + torch.gather(x, 1, ids[:2, None] % 2).sum()
                                                + torch.zeros(5, 2).index_add(0, ids, x[:3]).sum()
                                                + segment_sum(x, torch.tensor([1, 1, 0, 4, 2]), 5).sum()), [x])
    assert sorted(inside for _, inside in ops) == [False, False, False, True]


@pytest.mark.parametrize("kind", ["gcn", "sage", "meshgraphnet"])
def test_inventory_full_graph_gnn_losses(inventory, kind):
    from repro_torch.launch.train import gnn_loss
    from repro_torch.models import gnn

    cfg = gnn.GnnConfig(kind=kind, n_layers=2, d_in=6, d_hidden=8, d_out=3, d_edge_in=3)
    params = gnn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    s, r = _graph(30, 70, seed=1)
    rng = np.random.default_rng(2)
    batch = {"x": torch.as_tensor(rng.standard_normal((30, 6)).astype(np.float32)),
             "labels": torch.as_tensor(rng.integers(0, 3, 30), dtype=torch.int32), "senders": s, "receivers": r,
             "edge_feat": torch.as_tensor(rng.standard_normal((140, 3)).astype(np.float32))}
    leaves = [t.requires_grad_() for t in _tensors(params)]
    _assert_routed(_forward_backward(inventory, lambda: gnn_loss(cfg, params, batch), leaves))


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def test_inventory_sampled_sage_loss(inventory):
    from repro_torch.graphs import generators
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.launch.train import gnn_loss, sage_sampled_batch
    from repro_torch.models import gnn

    g = generators.two_cluster(n_per=40, seed=0)
    cfg = gnn.GnnConfig(kind="sage", n_layers=2, d_in=5, d_hidden=8, d_out=3)
    params = gnn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((g.n_nodes, 5)).astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, 3, g.n_nodes))
    ns = NeighborSampler(g, (4, 3), seed=0)
    batch = sage_sampled_batch(ns.sample_batch(np.arange(10)), x, labels)
    leaves = [t.requires_grad_() for t in _tensors(params)]
    _assert_routed(_forward_backward(inventory, lambda: gnn_loss(cfg, params, batch), leaves))


def test_inventory_mace_loss(inventory):
    from repro_torch.graphs import datasets
    from repro_torch.launch.train import gnn_loss
    from repro_torch.models import mace

    mol = datasets.load("molecules", scale=0.01)
    cfg = mace.MaceConfig(d_hidden=4, n_layers=2)
    params = mace.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    n_mols = int(mol.node_attrs["mol_id"].max()) + 1
    batch = {k: torch.as_tensor(mol.node_attrs[k]) for k in ("species", "pos", "mol_id")}
    batch.update(senders=torch.as_tensor(mol.senders), receivers=torch.as_tensor(mol.receivers),
                 target=torch.as_tensor(np.random.default_rng(0).normal(size=n_mols).astype(np.float32)))
    leaves = [t.requires_grad_() for t in _tensors(params)]
    _assert_routed(_forward_backward(inventory, lambda: gnn_loss(cfg, params, batch), leaves))


@pytest.fixture(scope="module")
def one_rank():
    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_inventory_halo_spmm_forward_and_backward(inventory, one_rank):
    from repro_torch.core import partitioners
    from repro_torch.distributed.halo import build_halo_program, make_partitioned_spmm
    from repro_torch.distributed.placement import build_layout
    from repro_torch.graphs import generators

    g = generators.two_cluster(n_per=30, seed=1)
    layout = build_layout(g, partitioners.random_partition(g.n_nodes, 4, seed=0), 1)
    spmm = make_partitioned_spmm(build_halo_program(g, layout), one_rank)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((layout.block, 3)).astype(np.float32))
    x.requires_grad_()
    ops = _forward_backward(inventory, lambda: (spmm(x) ** 2).sum(), [x])
    _assert_routed(ops)
    # the product, its two gathers' backwards and the exchange's backward
    assert len(ops) == 4


def test_inventory_one_mesh_didic_iteration(inventory, one_rank):
    from repro_torch.core.didic import DidicConfig
    from repro_torch.core.didic_distributed import didic_partition_distributed
    from repro_torch.graphs import generators
    from repro_torch.launch.mesh import make_replay_mesh

    g = generators.two_cluster(n_per=30, seed=2)
    mesh = make_replay_mesh(device="cpu")
    with inventory:
        didic_partition_distributed(g, DidicConfig(k=4, iterations=1), mesh, seed=0)
    _assert_routed(inventory.ops)


def test_package_exports():
    assert seg_pkg.KERNEL.name == "segment_sum" and seg_pkg.KERNEL.source == "segment_sum.cu"
