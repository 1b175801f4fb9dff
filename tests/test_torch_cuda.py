"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skipped where ``torch.cuda.is_available()`` is false
(the decision is taken inside the test, never at import). Imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.graphs import generators
from repro_torch.graphs.structure import padded_neighbors
from repro_torch.kernels.bsr_spmm import bell_matmul_ref, make_bell_matmul
from repro_torch.kernels.embedding_bag.ref import TEST_SHAPES as EMBEDDING_BAG_SHAPES
from repro_torch.kernels.flash_attention.ref import TEST_SHAPES as FLASH_SHAPES
from repro_torch.kernels.frontier import make_frontier_gather


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    dev = torch.device("cuda")
    before = kernels.launch_counts()
    rng = np.random.default_rng(7)
    pn = padded_neighbors(rng.integers(0, 500, 4000), rng.integers(0, 500, 4000),
                          rng.random(4000).astype(np.float32), 500, cap=3)
    x = torch.as_tensor(np.random.default_rng(8).normal(size=(500, 300)).astype(np.float32), device=dev)
    for mode in ("min", "sum"):
        got = make_frontier_gather(pn, mode=mode, device=dev)(x).cpu()
        want = make_frontier_gather(pn, mode=mode, device="cpu")(x.cpu())
        if mode == "min":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    bell = generators.two_cluster(n_per=70, seed=1).to_block_ell(block_size=128)
    xb = torch.rand(bell.padded_rows, 4)
    got = make_bell_matmul(bell, device=dev)(xb.to(dev)).cpu()
    torch.testing.assert_close(got, bell_matmul_ref(
        *(torch.as_tensor(a) for a in (bell.blocks, bell.block_cols, bell.block_mask)), xb),
        rtol=1e-5, atol=1e-5)
    after = kernels.launch_counts()
    assert after["frontier_gather"] == before["frontier_gather"] + 2
    assert after["bell_matmul"] == before["bell_matmul"] + 1


@pytest.mark.cuda
def test_cuda_gis_replay_matches_scalar_oracle():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    from repro_torch.core import partitioners
    from repro_torch.core.traffic import execute_ops, generate_ops
    from repro_torch.graphs import datasets

    g = datasets.load("gis", scale=0.005)
    ops = generate_ops(g, n_ops=100, seed=3, pattern="gis_short")
    parts = partitioners.random_partition(g.n_nodes, 4, seed=1)
    before = kernels.launch_counts()["frontier_gather"]
    got = execute_ops(g, ops, parts, 4, engine="batched", device="cuda")
    assert kernels.launch_counts()["frontier_gather"] > before
    want = execute_ops(g, ops, parts, 4, engine="scalar")
    for field in ("per_op_total", "per_op_global", "per_partition", "per_vertex"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_embedding_bag_matches_plain_version():
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_auto, embedding_bag_ref

    dev = _cuda_or_skip()
    before = kernels.launch_counts()["embedding_bag"]
    rng = np.random.default_rng(0)
    for v, d, b, l in EMBEDDING_BAG_SHAPES:
        table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32), device=dev)
        idx = torch.as_tensor(rng.integers(0, v, size=(b, l)).astype(np.int32), device=dev)
        w = rng.random((b, l)).astype(np.float32)
        w[:, -1] = 0.0
        w = torch.as_tensor(w, device=dev)
        torch.testing.assert_close(embedding_bag(table, idx, w), embedding_bag_ref(table, idx, w),
                                   rtol=1e-6, atol=1e-6)
    table = torch.as_tensor(rng.normal(size=(50, 8)).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, 50, size=(4, 6)).astype(np.int32), device=dev)
    mask = torch.as_tensor((rng.random((4, 6)) > 0.3).astype(np.float32), device=dev)
    got = embedding_bag_auto(table, idx, mask, mode="mean").cpu()
    want = embedding_bag_auto(table.cpu(), idx.cpu(), mask.cpu(), mode="mean")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert kernels.launch_counts()["embedding_bag"] == before + len(EMBEDDING_BAG_SHAPES) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,qoff", FLASH_SHAPES)
def test_cuda_flash_attention_matches_plain_version(b, hq, hkv, tq, tk, dh, causal, qoff):
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    dev = _cuda_or_skip()
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.normal(size=(b * hq, tq, dh)).astype(np.float32), device=dev)
    k = torch.as_tensor(rng.normal(size=(b * hkv, tk, dh)).astype(np.float32), device=dev)
    v = torch.as_tensor(rng.normal(size=(b * hkv, tk, dh)).astype(np.float32), device=dev)
    before = kernels.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, q_offset=qoff)
    assert kernels.launch_counts()["flash_attention"] == before + 1
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal, q_offset=qoff),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_and_mha_layout():
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention, mha

    dev = _cuda_or_skip()
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.normal(size=(4, 64, 32)), dtype=torch.bfloat16, device=dev)
    k = torch.as_tensor(rng.normal(size=(2, 64, 32)), dtype=torch.bfloat16, device=dev)
    v = torch.as_tensor(rng.normal(size=(2, 64, 32)), dtype=torch.bfloat16, device=dev)
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), attention_ref(q.float(), k.float(), v.float()),
                               rtol=3e-2, atol=3e-2)
    rng = np.random.default_rng(2)
    q4 = torch.as_tensor(rng.normal(size=(2, 16, 4, 8)).astype(np.float32), device=dev)
    k4 = torch.as_tensor(rng.normal(size=(2, 16, 2, 8)).astype(np.float32), device=dev)
    v4 = torch.as_tensor(rng.normal(size=(2, 16, 2, 8)).astype(np.float32), device=dev)
    out = mha(q4, k4, v4, causal=True)
    assert out.shape == (2, 16, 4, 8)
    # mha on the CPU is held to the JAX package's mha by tests/test_torch_kernels.py.
    want = mha(q4.cpu(), k4.cpu(), v4.cpu(), causal=True)
    torch.testing.assert_close(out.cpu(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,qoff", [
    (2, 8, 2, 200, 200, 128, True, 0),    # granite's head dim, ragged T, groups of 4
    (1, 4, 2, 37, 130, 100, True, 93),    # a chunk of queries late in a longer cache
    (1, 2, 1, 70, 33, 48, False, 0),      # Tq > Tk, non-causal, head dim not a power of 2
])
def test_cuda_flash_attention_ragged_and_wide_heads(dtype, tol, b, hq, hkv, tq, tk, dh, causal, qoff):
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    dev = _cuda_or_skip()
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.normal(size=(n, t, dh)), dtype=dtype, device=dev)
               for n, t in ((b * hq, tq), (b * hkv, tk), (b * hkv, tk)))
    got = flash_attention(q, k, v, causal=causal, q_offset=qoff)
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal, q_offset=qoff)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


def _bf16_attention_inputs(dev, seed, b, hq, hkv, tq, tk, dh):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(n, t, dh)), dtype=torch.bfloat16, device=dev)
            for n, t in ((b * hq, tq), (b * hkv, tk), (b * hkv, tk)))


@pytest.mark.cuda
def test_cuda_flash_attention_wgmma_ragged_offset_groups():
    """The tensor-core kernel at granite's head dim with a ragged Tq (200),
    q_offset 93 and groups of 4, within two bfloat16 steps (atol 4e-3 + rtol
    1.6e-2) of float32 attention rounded to bfloat16."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    dev = _cuda_or_skip()
    b, hq, hkv, tq, qoff, dh = 2, 8, 2, 200, 93, 128
    q, k, v = _bf16_attention_inputs(dev, 5, b, hq, hkv, tq, tq + qoff, dh)
    got = flash_attention(q, k, v, causal=True, q_offset=qoff)
    want = attention_ref(q.float(), k.float(), v.float(), causal=True, q_offset=qoff).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=4e-3)


@pytest.mark.cuda
def test_cuda_flash_attention_route_counts():
    """bfloat16 calls (padded head dims too) count on the wgmma route, float32
    calls on the ffma route, each also once on the kernel's count; the
    uncounted timing entry counts nothing."""
    from repro_torch.kernels.flash_attention import KERNEL, flash_attention
    from repro_torch.kernels.flash_attention.ops import _ffma_bf16_uncounted

    dev = _cuda_or_skip()
    before, routes = KERNEL.launches, dict(KERNEL.route_launches)
    for dh in (128, 48):
        flash_attention(*_bf16_attention_inputs(dev, 6, 1, 4, 2, 64, 64, dh))
    q, k, v = (t.float() for t in _bf16_attention_inputs(dev, 7, 1, 4, 2, 64, 64, 64))
    flash_attention(q, k, v)
    _ffma_bf16_uncounted(*_bf16_attention_inputs(dev, 8, 1, 4, 2, 64, 64, 128))
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 3
    assert KERNEL.route_launches.get("wgmma", 0) == routes.get("wgmma", 0) + 2
    assert KERNEL.route_launches.get("ffma", 0) == routes.get("ffma", 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("bs", [16, 32, 128])
@pytest.mark.parametrize("f", [2, 4, 20])
def test_cuda_bell_matmul_bit_repeatable(dtype, tol, bs, f):
    """Two launches on the same inputs give the same bits (each output is
    summed in one fixed order, never atomically), within the plain version's
    tolerance."""
    from repro_torch.kernels.bsr_spmm import bell_matmul

    dev = _cuda_or_skip()
    bell = generators.two_cluster(n_per=70, p_in=0.2, p_out=0.02, seed=1).to_block_ell(block_size=bs)
    blocks = torch.as_tensor(bell.blocks, device=dev).to(dtype)
    cols = torch.as_tensor(bell.block_cols, device=dev)
    mask = torch.as_tensor(bell.block_mask, device=dev).to(torch.int32)
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(bell.padded_rows, f)), dtype=dtype, device=dev)
    first = bell_matmul(blocks, cols, mask, x)
    second = bell_matmul(blocks, cols, mask, x)
    assert torch.equal(first, second)
    torch.testing.assert_close(first.float(), bell_matmul_ref(blocks, cols, mask, x).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bs", [(torch.float32, 2), (torch.float32, 6), (torch.bfloat16, 4)])
def test_cuda_bell_matmul_rejects_short_block_rows(dtype, bs):
    """The kernel copies block rows in 16-byte units: on the card a block
    size whose row is not a multiple of 16 bytes raises (no silent switch to
    the plain version), while the same layout on the CPU runs the plain
    version."""
    from repro_torch.kernels.bsr_spmm import bell_matmul

    dev = _cuda_or_skip()
    bell = generators.two_cluster(n_per=10, p_in=0.3, p_out=0.05, seed=2).to_block_ell(block_size=bs)
    host = (torch.as_tensor(bell.blocks).to(dtype), torch.as_tensor(bell.block_cols),
            torch.as_tensor(bell.block_mask).to(torch.int32),
            torch.as_tensor(np.random.default_rng(4).normal(size=(bell.padded_rows, 4)), dtype=dtype))
    assert bell_matmul(*host).shape == (bell.padded_rows, 4)
    before = kernels.KERNELS["bell_matmul"].launches
    with pytest.raises(ValueError, match="16-byte"):
        bell_matmul(*(t.to(dev) for t in host))
    assert kernels.KERNELS["bell_matmul"].launches == before


def _nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same NaN mask, and equal values everywhere else (inf included)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [7, 128, 300])
@pytest.mark.parametrize("cap", [None, 3])
def test_cuda_frontier_gather_row_order_bit_exact(c, cap):
    """With a random permutation as its row schedule the kernel gives the
    plain version's min bit for bit, and in both modes the same bits as the
    call without a schedule (each row is computed the same way wherever it
    runs)."""
    from repro_torch.kernels.frontier import frontier_gather, frontier_gather_ref

    dev = _cuda_or_skip()
    rng = np.random.default_rng(11)
    pn = padded_neighbors(rng.integers(0, 700, 6000), rng.integers(0, 700, 6000),
                          rng.random(6000).astype(np.float32), 700, cap=cap)
    x = torch.as_tensor(rng.normal(size=(700, c)).astype(np.float32), device=dev)
    x[torch.as_tensor(rng.random(700) < 0.1, device=dev)] = float("inf")
    nbr = torch.as_tensor(pn.nbr, device=dev)
    perm = torch.as_tensor(rng.permutation(700).astype(np.int32), device=dev)
    for mode in ("min", "sum"):
        w = np.where(pn.mask > 0, pn.w, np.float32(np.inf)) if mode == "min" else pn.w * pn.mask
        w = torch.as_tensor(w.astype(np.float32), device=dev)
        got = frontier_gather(x, nbr, w, mode=mode, order=perm)
        assert torch.equal(got, frontier_gather(x, nbr, w, mode=mode))
        want = frontier_gather_ref(x, nbr, w, mode=mode)
        if mode == "min":
            assert torch.equal(got, want)
        else:
            fin = torch.isfinite(want)
            assert torch.equal(fin, torch.isfinite(got))
            torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 2])
def test_cuda_frontier_gather_min_propagates_nan(cap):
    """NaN and -inf in x, row 0 included (every padded slot reads it with
    weight +inf, and -inf + +inf is NaN): the kernel's min propagates NaN
    as torch.minimum and jnp.minimum do, equal to the plain version on the
    card and on the CPU in NaN mask and in every other value; with a spill
    tail, the scatter-min epilogue is held to the same bar."""
    from repro_torch.kernels.frontier import frontier_gather, frontier_gather_ref

    dev = _cuda_or_skip()
    rng = np.random.default_rng(12)
    n, c = 600, 128
    pn = padded_neighbors(rng.integers(0, n, 3000), rng.integers(0, n, 3000),
                          rng.random(3000).astype(np.float32), n, cap=cap)
    assert (pn.mask == 0).any() and (cap is None or pn.n_spill > 0)
    x = rng.normal(size=(n, c)).astype(np.float32)
    x[0, :4] = [np.nan, -np.inf, np.inf, np.nan]
    x[rng.random((n, c)) < 0.02] = np.nan
    x[rng.random((n, c)) < 0.02] = -np.inf
    xc = torch.as_tensor(x, device=dev)
    w = torch.as_tensor(np.where(pn.mask > 0, pn.w, np.float32(np.inf)), device=dev)
    nbr = torch.as_tensor(pn.nbr, device=dev)
    got = frontier_gather(xc, nbr, w, mode="min")
    assert bool(torch.isnan(got).any()) and bool(torch.isneginf(got).any())
    assert _nan_equal(got, frontier_gather_ref(xc, nbr, w, mode="min"))
    assert _nan_equal(got.cpu(), frontier_gather_ref(xc.cpu(), nbr.cpu(), w.cpu(), mode="min"))
    full = make_frontier_gather(pn, mode="min", device=dev)(xc)
    assert _nan_equal(full.cpu(), make_frontier_gather(pn, mode="min", device="cpu")(torch.as_tensor(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 33, 100])
@pytest.mark.parametrize("d", [18, 64, 130])
def test_cuda_embedding_bag_widths_and_nonfinite_rows(l, d):
    """Every slot counts, weight 0 or not: an inf row under a weight-0 slot
    gives NaN as in the plain version (the reference multiplies by 0).
    Within 1e-6 of the plain version elsewhere, with mean weights as DIN
    pools (the bar is DIN's: float32 sums of 100 unit-size terms taken in
    another order differ by more), at bag lengths that are one slot, one
    over a warp and DIN's, and at widths of 8-byte parts (18, 64, more than
    32 parts: 130); two launches give the same bits."""
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref

    dev = _cuda_or_skip()
    rng = np.random.default_rng(13)
    v, b = 300, 70
    table = rng.normal(size=(v, d)).astype(np.float32)
    table[7] = np.inf
    idx = rng.integers(8, v, size=(b, l)).astype(np.int32)
    w = rng.random((b, l)).astype(np.float32)
    idx[: b // 2, -1] = 7      # an inf row under a weight-0 slot: NaN
    w[: b // 2, -1] = 0.0
    w[b // 2:, 0] = 0.0        # a weight-0 slot over a finite row: no effect
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-9)  # mean weights, as DIN pools
    args = [torch.as_tensor(a, device=dev) for a in (table, idx, w)]
    got = embedding_bag(*args)
    want = embedding_bag_ref(*args)
    nan = torch.isnan(want)
    assert bool(nan[: b // 2].all()) and not bool(nan[b // 2:].any())
    assert torch.equal(torch.isnan(got), nan)
    torch.testing.assert_close(got[~nan], want[~nan], rtol=1e-6, atol=1e-6)
    assert torch.equal(got.nan_to_num(0.0), embedding_bag(*args).nan_to_num(0.0))


@pytest.mark.cuda
def test_cuda_embedding_bag_large_table():
    """A 28.8 MB table (400,000 rows of 18) and DIN's bag length: within
    1e-6 of the plain version with mean weights, an inf row under a
    weight-0 slot gives NaN, two launches give the same bits."""
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref

    dev = _cuda_or_skip()
    rng = np.random.default_rng(14)
    v, d, b, l = 400_000, 18, 512, 100
    table = torch.as_tensor(rng.normal(scale=0.05, size=(v, d)).astype(np.float32), device=dev)
    table[399_000] = float("inf")
    idx = torch.as_tensor(rng.integers(0, v - 1000, size=(b, l)).astype(np.int32), device=dev)
    mask = torch.as_tensor((np.arange(l)[None, :] < rng.integers(1, l + 1, size=(b, 1))).astype(np.float32),
                           device=dev)
    idx[:8, -1] = 399_000
    mask[:8, -1] = 0.0
    w = mask / torch.clamp(mask.sum(dim=1, keepdim=True), min=1e-9)
    got = embedding_bag(table, idx, w)
    want = embedding_bag_ref(table, idx, w)
    nan = torch.isnan(want)
    assert bool(nan[:8].all()) and not bool(nan[8:].any()) and torch.equal(torch.isnan(got), nan)
    torch.testing.assert_close(got[8:], want[8:], rtol=1e-6, atol=1e-6)
    assert torch.equal(got.nan_to_num(0.0), embedding_bag(table, idx, w).nan_to_num(0.0))


@pytest.mark.cuda
def test_cuda_dynamic_run_with_growth_matches_scalar_oracle():
    """Three slices of the dynamic cycle on GIS with vertex growth (least
    traffic, 30 % inserts, maintenance every slice): each slice's counters
    on the card equal the scalar oracle on that slice's map and grown graph,
    and the replays went through frontier_gather."""
    from repro_torch.core.didic import DidicConfig
    from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.traffic import execute_ops
    from repro_torch.graphs import datasets

    dev = _cuda_or_skip()
    g = datasets.load("gis", scale=0.005)
    svc = PartitionedGraphService(g, 4, DidicConfig(k=4, iterations=10), device=dev)
    svc.partition_didic(seed=0)
    ops = svc.make_ops(n_ops=100, seed=3)
    checked = []

    def on_slice(i, result):
        want = execute_ops(svc.graph, ops, svc.parts, 4, engine="scalar")
        for field in ("per_op_total", "per_op_global", "per_partition", "per_vertex"):
            np.testing.assert_array_equal(getattr(result, field), getattr(want, field), err_msg=field)
        checked.append(svc.graph.n_nodes)

    before = kernels.launch_counts()["frontier_gather"]
    run = DynamicExperimentRuntime(svc, insert_method="least_traffic", seed=0).run(
        ops, n_slices=3, amount=0.05, maintain_every=1, insert_rate=0.3, on_slice=on_slice)
    assert kernels.launch_counts()["frontier_gather"] > before
    assert len(checked) == 3 and checked[0] > g.n_nodes and checked[2] > checked[0]
    assert sum(r.inserted for r in run.records) == svc.graph.n_nodes - g.n_nodes
    assert all(r.maintained and r.migrated >= 0 for r in run.records)
