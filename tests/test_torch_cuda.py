"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skipped where ``torch.cuda.is_available()`` is false
(the decision is taken inside the test, never at import). Imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

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
from repro_torch.optim.adamw import tree_map


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


@pytest.mark.cuda
def test_cuda_gis_recovered_run_bit_exact():
    """A GIS dynamic run on the card under a pre-commit crash, a maintenance
    timeout and a post-commit crash equals the uninterrupted run on all four
    counters of every slice, its replays through ``frontier_gather``."""
    dev = _cuda_or_skip()
    from repro_torch.core.didic import DidicConfig
    from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
    from repro_torch.core.fault import FaultPlan, RetryPolicy
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.recovery import run_with_recovery
    from repro_torch.core.traffic import generate_ops
    from repro_torch.graphs import datasets

    g = datasets.load("gis", scale=0.005)
    ops = generate_ops(g, n_ops=60, seed=3)
    parts0 = PartitionedGraphService(g, 4, DidicConfig(k=4, iterations=6),
                                     device=dev).partition_didic(seed=0).parts

    def make():
        svc = PartitionedGraphService(g, 4, DidicConfig(k=4, iterations=6), device=dev)
        return DynamicExperimentRuntime(svc.partition_with(parts0), "least_traffic", seed=7)

    kw = dict(n_slices=5, amount=0.05, maintain_every=2, insert_rate=0.3)
    base, got = {}, {}
    before = kernels.launch_counts()["frontier_gather"]
    ref = make().run(ops, on_slice=lambda i, r: base.__setitem__(i, r), **kw)
    plan = (FaultPlan().crash(1, site="apply:pre_commit").timeout_maintenance(3)
            .crash(3, site="apply:post_commit"))
    out, stats = run_with_recovery(make, g, ops, fault_plan=plan, snapshot_every=2,
                                   retry_policy=RetryPolicy(sleep=lambda s: None),
                                   on_slice=lambda i, r: got.__setitem__(i, r), **kw)
    assert kernels.launch_counts()["frontier_gather"] > before
    assert stats.recoveries == 2
    for i in range(kw["n_slices"]):
        for field in ("per_op_total", "per_op_global", "per_partition", "per_vertex"):
            np.testing.assert_array_equal(getattr(got[i], field), getattr(base[i], field),
                                          err_msg=f"slice {i} {field}")
    assert [vars(r) for r in out.records] == [vars(r) for r in ref.records]
    np.testing.assert_array_equal(out.parts, ref.parts)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(56, 8), (32, 4), (16, 16)])
def test_cuda_flash_attention_wgmma_new_groups(hq, hkv):
    """The tensor-core kernel at the GQA groups of yi-34b and
    deepseek-coder-33b (7), qwen3-moe-30b-a3b (8) and deepseek-moe-16b (1):
    Dh 128, bf16, causal, ragged Tq (333, two batches), within two bfloat16
    steps of float32 attention rounded to bfloat16, each call on ``wgmma``."""
    from repro_torch.kernels.flash_attention import KERNEL, attention_ref, flash_attention

    dev = _cuda_or_skip()
    q, k, v = _bf16_attention_inputs(dev, 11, 2, hq, hkv, 333, 333, 128)
    before = KERNEL.route_launches.get("wgmma", 0)
    got = flash_attention(q, k, v, causal=True)
    assert KERNEL.route_launches.get("wgmma", 0) == before + 1
    want = attention_ref(q.float(), k.float(), v.float(), causal=True).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=4e-3)


def _moe_case(dev, tied: bool = False):
    from repro_torch.models.moe import MoeConfig, moe_init

    cfg = MoeConfig(n_experts=16, top_k=4, n_shared=1, d_ff=128, capacity_factor=1.0)
    p = moe_init(torch.Generator().manual_seed(0), 256, cfg, torch.bfloat16, "cpu")
    if tied:
        p["router"][:, 5] = p["router"][:, 2]
        p["router"][:, 9] = p["router"][:, 2]
    x = torch.randn((2, 384, 256), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    on_card = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
               for k, v in p.items()}
    return cfg, p, x, on_card, x.to(dev)


@pytest.mark.cuda
def test_cuda_moe_fwd_matches_cpu_and_repeats_bit_for_bit():
    """``moe_fwd`` on the card against the CPU run of the same bf16 weights
    (the same top-k choices, capacity drops included; outputs within 0.0625,
    the CPU tests' bf16 bar against the JAX package), and two card runs give
    the same bits: the buffer write and the combine use no atomics."""
    from repro_torch.models.moe import capacity, moe_fwd, route

    dev = _cuda_or_skip()
    cfg, p, x, pc, xc = _moe_case(dev)
    idx = route(pc, xc.reshape(-1, 256), cfg)[2]
    np.testing.assert_array_equal(idx.cpu().numpy(), route(p, x.reshape(-1, 256), cfg)[2].numpy())
    assert int(torch.bincount(idx.reshape(-1)).max()) > capacity(768, cfg)  # some assignments drop
    y, aux = moe_fwd(pc, xc, cfg)
    y_cpu, aux_cpu = moe_fwd(p, x, cfg)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    torch.testing.assert_close(y.float().cpu(), y_cpu.float(), rtol=0, atol=0.0625)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=1e-5, atol=1e-6)
    y2, aux2 = moe_fwd(pc, xc, cfg)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


@pytest.mark.cuda
def test_cuda_route_breaks_ties_to_the_lower_expert():
    """Router columns 5 and 9 copy column 2: on the card the top-k choices
    equal the CPU's, which the CPU tests hold to ``jax.lax.top_k``."""
    from repro_torch.models.moe import route

    dev = _cuda_or_skip()
    cfg, p, x, pc, xc = _moe_case(dev, tied=True)
    idx = route(pc, xc.reshape(-1, 256), cfg)[2].cpu()
    want = route(p, x.reshape(-1, 256), cfg)[2]
    assert bool((torch.isin(want, torch.tensor([2, 5, 9])).sum(dim=1) >= 2).any())
    assert torch.equal(idx, want)


# ------------------------------------------------------------- training
#: tests/test_torch_train.py's bar for the trainer's losses
LOSS_RTOL = 1e-5


def _grad_inputs(dev, seed, dtype, b, hq, hkv, tq, tk, dh):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.as_tensor(rng.normal(size=(b * h, t, dh)).astype(np.float32), device=dev).to(dtype)
                     for h, t in ((hq, tq), (hkv, tk), (hkv, tk), (hq, tq)))
    return q.requires_grad_(True), k.requires_grad_(True), v.requires_grad_(True), dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,qoff", FLASH_SHAPES)
def test_cuda_flash_attention_backward_matches_plain_autograd(dtype, tol, b, hq, hkv, tq, tk, dh, causal, qoff):
    """The ``autograd.Function`` on the card (the kernel forward, the kernel
    backward) against autograd through the plain version: one forward
    launch, one ``flash_attention_bwd`` launch on the dtype's route;
    float32 within 1e-5 (the CPU tests' bar against ``jax.grad``), bfloat16
    within 3e-2."""
    from repro_torch.kernels.flash_attention import BWD_KERNEL, KERNEL, attention_ref, flash_attention

    dev = _cuda_or_skip()
    q, k, v, dout = _grad_inputs(dev, 12, dtype, b, hq, hkv, tq, tk, dh)
    before, bwd_before = KERNEL.launches, BWD_KERNEL.launches
    route = "ffma" if dtype == torch.float32 else "wgmma"
    bwd_route = BWD_KERNEL.route_launches.get(route, 0)
    got = torch.autograd.grad(flash_attention(q, k, v, causal=causal, q_offset=qoff), (q, k, v), dout)
    assert KERNEL.launches == before + 1
    assert BWD_KERNEL.launches == bwd_before + 1 and BWD_KERNEL.route_launches[route] == bwd_route + 1
    want = torch.autograd.grad(attention_ref(q, k, v, causal=causal, q_offset=qoff), (q, k, v), dout)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,qoff", FLASH_SHAPES)
def test_cuda_flash_attention_bwd_matches_plain_lse_backward(dtype, tol, b, hq, hkv, tq, tk, dh, causal, qoff):
    """``flash_attention_bwd`` against the plain o/lse backward on the same
    saved output and log-sum-exp (the kernel forward's, itself within 1e-5
    of the plain log-sum-exp in float32), and two calls bit-equal."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_lse_ref, attention_lse_ref

    dev = _cuda_or_skip()
    q, k, v, dout = (t.detach() for t in _grad_inputs(dev, 13, dtype, b, hq, hkv, tq, tk, dh))
    out, lse = ops._kernel_call(q, k, v, causal=causal, q_offset=qoff, with_lse=True)
    want_out, want_lse = attention_lse_ref(q, k, v, causal=causal, q_offset=qoff)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)
    got = ops._bwd_kernel_call(q, k, v, out, lse, dout, causal=causal, q_offset=qoff)
    want = attention_bwd_lse_ref(q, k, v, out, lse, dout, causal=causal, q_offset=qoff)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    again = ops._bwd_kernel_call(q, k, v, out, lse, dout, causal=causal, q_offset=qoff)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


#: Several 128-key tiles and a GQA group of 4 into every 64-row query tile:
#: dQ summed over key tiles in order, dK and dV over the group.
MULTI_TILE_BWD_SHAPES = [(1, 8, 2, t, t + qoff, 128, causal, qoff)
                         for t in (1024, 1000) for causal, qoff in ((True, 0), (False, 0), (True, 24))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,qoff", MULTI_TILE_BWD_SHAPES)
def test_cuda_flash_attention_bwd_multi_tile_gqa(b, hq, hkv, tq, tk, dh, causal, qoff):
    """The bfloat16 ``wgmma`` backward where each query tile takes dQ from
    8 key tiles and each kv head sums dK and dV over 4 q heads (T 1,024 and
    a ragged 1,000; causal, not, and q_offset 24): within 3e-2 of the plain
    o/lse backward, one launch on ``wgmma``, three calls bit-equal."""
    from repro_torch.kernels.flash_attention import BWD_KERNEL, ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_lse_ref

    dev = _cuda_or_skip()
    q, k, v, dout = (t.detach() for t in _grad_inputs(dev, 14, torch.bfloat16, b, hq, hkv, tq, tk, dh))
    out, lse = ops._kernel_call(q, k, v, causal=causal, q_offset=qoff, with_lse=True)
    before = BWD_KERNEL.route_launches.get("wgmma", 0)
    got = ops._bwd_kernel_call(q, k, v, out, lse, dout, causal=causal, q_offset=qoff)
    assert BWD_KERNEL.route_launches["wgmma"] == before + 1
    want = attention_bwd_lse_ref(q, k, v, out, lse, dout, causal=causal, q_offset=qoff)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=3e-2, atol=3e-2)
    for _ in range(2):
        again = ops._bwd_kernel_call(q, k, v, out, lse, dout, causal=causal, q_offset=qoff)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,b,l", EMBEDDING_BAG_SHAPES + ((1_000_000, 18, 4096, 100),))
def test_cuda_embedding_bag_backward_matches_plain_autograd(v, d, b, l):
    """The same for ``embedding_bag``, at the JAX tests' shapes and at DIN's
    item table (1,000,000 x 18, bags of 100): the table's gradient within
    1e-6, the weights' within 1e-6 of their largest (D-term dot products)."""
    from repro_torch.kernels.embedding_bag import KERNEL, embedding_bag, embedding_bag_ref

    dev = _cuda_or_skip()
    rng = np.random.default_rng(13)
    table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32), device=dev).requires_grad_(True)
    idx = torch.as_tensor(rng.integers(0, v, size=(b, l)).astype(np.int32), device=dev)
    w = torch.as_tensor(rng.random((b, l)).astype(np.float32), device=dev).requires_grad_(True)
    dout = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
    before = KERNEL.launches
    got_t, got_w = torch.autograd.grad(embedding_bag(table, idx, w), (table, w), dout)
    assert KERNEL.launches == before + 1
    want_t, want_w = torch.autograd.grad(embedding_bag_ref(table, idx, w), (table, w), dout)
    torch.testing.assert_close(got_t, want_t, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_w, want_w, rtol=0, atol=1e-6 * float(want_w.abs().max()))


@pytest.mark.cuda
def test_cuda_lm_gradients_reach_attention_weights():
    """A loss through ``transformer.forward`` on the card: every layer's
    wq, wk and wv get a non-zero gradient through ``flash_attention``, and
    every leaf's gradient equals the CPU's within 1e-5 of its largest entry."""
    from repro_torch.kernels.flash_attention import KERNEL
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import leaves, tree_map, tree_unflatten

    dev = _cuda_or_skip()
    cfg = tf.TransformerConfig(n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, d_ff=512, vocab=512)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(14).integers(0, 512, size=(4, 65))
    grads = {}
    for device in (dev, torch.device("cpu")):
        live = tree_map(lambda p: p.to(device).requires_grad_(True), params)
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=device),
                 "labels": torch.as_tensor(toks[:, 1:], device=device)}
        before = KERNEL.launches
        g = torch.autograd.grad(tf.loss_fn(cfg, live, batch), list(leaves(live)))
        assert KERNEL.launches == before + (cfg.n_layers if device.type == "cuda" else 0)
        grads[device.type] = [t.cpu() for t in g]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    attn = tree_unflatten(params, grads["cuda"])["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        assert bool((attn[name].abs().amax(dim=(1, 2)) > 0).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-8b", "din"])
def test_cuda_reduced_trainer_matches_cpu(arch):
    """The training launcher's reduced config, 10 steps on the card and on
    the CPU from the same weights: the logged losses within 1e-5."""
    from repro_torch.launch.serve import ARCHS
    from repro_torch.launch.train import RUNNERS

    dev = _cuda_or_skip()
    run = RUNNERS[ARCHS[arch][0]]
    card, cpu = run(arch, 10, None, device=dev), run(arch, 10, None, device="cpu")
    assert card.step == cpu.step == 10
    np.testing.assert_allclose([m["loss"] for m in card.metrics_log], [m["loss"] for m in cpu.metrics_log],
                               rtol=LOSS_RTOL)


#: the GNN and MACE card-against-CPU bar: the segment sums are the CPU's bit
#: for bit (the segment_sum kernel adds in the CPU's order), but cuBLAS
#: reduces in another order than the CPU, so the card is held to the CPU
#: within 1e-4 relative; a second card run must give the same bits
GNN_CARD_RTOL = 1e-4
#: MeshGraphNet's and MACE's launcher runs after step 5, where a ReLU input
#: within rounding of zero, or MACE's overshooting steps, part two float32
#: runs (tests/test_torch_gnn.py, tests/test_torch_mace.py DRIFT_RTOL)
GNN_DRIFT_RTOL = 1e-2


def _gnn_forwards(dev):
    """GCN, GraphSAGE (full and sampled), MeshGraphNet and MACE outputs on
    ``dev``, from weights and inputs drawn on the CPU."""
    from repro_torch.graphs import datasets
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.models import gnn, mace

    g = datasets.load("cora_like", scale=0.2)
    s, r, _ = (torch.as_tensor(a, device=dev) for a in g.undirected)
    x_np = np.random.default_rng(0).normal(size=(g.n_nodes, 24)).astype(np.float32)
    x = torch.as_tensor(x_np, device=dev)
    out = {}
    for kind in ("gcn", "sage", "meshgraphnet"):
        cfg = gnn.GnnConfig(kind=kind, n_layers=3, d_in=24, d_hidden=32, d_out=5, d_edge_in=4)
        p = tree_map(lambda t: t.to(dev), gnn.init(cfg, torch.Generator().manual_seed(1), device="cpu"))
        if kind == "gcn":
            out[kind] = gnn.gcn_forward(cfg, p, x, s, r)
        elif kind == "sage":
            out[kind] = gnn.sage_forward_full(cfg, p, x, s, r)
            blocks = NeighborSampler(g, (5, 3), seed=0).sample_batch(np.arange(64))
            cfg2 = dataclasses.replace(cfg, n_layers=2)
            out["sage_sampled"] = gnn.sage_forward_sampled(
                cfg2, p, [torch.as_tensor(x_np[blocks[0].src_nodes], device=dev)],
                [torch.as_tensor(b.neighbors, device=dev) for b in blocks],
                [torch.as_tensor(b.mask, device=dev) for b in blocks], [b.n_targets for b in blocks])
        else:
            ef = torch.randn((s.shape[0], 4), generator=torch.Generator().manual_seed(2)).to(dev)
            out[kind] = gnn.mgn_forward(cfg, p, x, ef, s, r)
    mol = datasets.load("molecules", scale=0.1)
    cfg = mace.MaceConfig(d_hidden=32, n_layers=2)
    p = tree_map(lambda t: t.to(dev), mace.init(cfg, torch.Generator().manual_seed(3), device="cpu"))
    args = [torch.as_tensor(a, device=dev) for a in (mol.node_attrs["species"], mol.node_attrs["pos"],
                                                     mol.senders, mol.receivers, mol.node_attrs["mol_id"])]
    out["mace"], out["mace_s"] = mace.forward(cfg, p, *args, 12)
    q, _ = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))
    q[:, 0] *= np.sign(np.linalg.det(q))
    args[1] = args[1] @ torch.as_tensor(q.astype(np.float32), device=dev)
    out["mace_rotated"], _ = mace.forward(cfg, p, *args, 12)
    return {k: v.detach().cpu() for k, v in out.items()}


@pytest.mark.cuda
def test_cuda_gnn_and_mace_forwards_match_cpu():
    """Each GNN forward and MACE's energies on the card against the CPU
    within ``GNN_CARD_RTOL``, and a second card run bit-equal; MACE's energy
    of rotated positions equal within 1e-4, as on the CPU."""
    dev = _cuda_or_skip()
    card, again, cpu = _gnn_forwards(dev), _gnn_forwards(dev), _gnn_forwards(torch.device("cpu"))
    for name, want in cpu.items():
        got = card[name]
        assert torch.isfinite(got).all(), name
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=GNN_CARD_RTOL, atol=GNN_CARD_RTOL * scale, msg=name)
        assert torch.equal(got.view(torch.int32), again[name].view(torch.int32)), name
    torch.testing.assert_close(card["mace_rotated"], card["mace"], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,exact", [("gcn-cora", 10), ("graphsage-reddit", 10), ("meshgraphnet", 5),
                                        ("mace", 5)])
def test_cuda_gnn_launcher_trainer_matches_cpu(arch, exact):
    """The GNN launcher's task, 10 steps on the card and on the CPU from the
    same weights and labels: the losses within ``GNN_CARD_RTOL`` over the
    first ``exact`` steps, all within ``GNN_DRIFT_RTOL``."""
    from repro_torch.launch.train import train_gnn

    dev = _cuda_or_skip()
    card, cpu = train_gnn(arch, 10, None, device=dev), train_gnn(arch, 10, None, device="cpu")
    assert card.step == cpu.step == 10
    got, want = [m["loss"] for m in card.metrics_log], [m["loss"] for m in cpu.metrics_log]
    np.testing.assert_allclose(got[:exact], want[:exact], rtol=GNN_CARD_RTOL)
    np.testing.assert_allclose(got, want, rtol=GNN_DRIFT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,f", [(0, 5, 3), (1, 1, 1), (5_000, 700, 1), (20_000, 3_000, 4), (9_000, 64, 37),
                                   (3_000, 900, 130), (40_000, 40, 16), (60_000, 6, 4), (30_000, 4, 600)])
def test_cuda_segment_sum_equals_the_cpu_bit_for_bit(e, n, f):
    """``segment_sum`` on the card against its plain version on the CPU,
    bit for bit (unsorted ids with repeats, empty segments, F below, at and
    above a warp), two launches bit-equal, one counted launch each; the
    gather's backward on the card against the plain version's on the CPU
    (``index_add_`` of the gradient, in edge order), bit for bit; float64
    refused."""
    from repro_torch.kernels.segment_sum import KERNEL, gather, segment_sum, segment_sum_ref

    dev = _cuda_or_skip()
    rng = np.random.default_rng(e + n + f)
    data = (rng.standard_normal((e, f)) * np.exp(3 * rng.standard_normal((e, 1)))).astype(np.float32)
    ids = rng.integers(0, max(n // 2, 1), size=e).astype(np.int32)
    d_card, i_card = torch.as_tensor(data, device=dev), torch.as_tensor(ids, device=dev)
    before = KERNEL.launches
    got = segment_sum(d_card, i_card, n)
    again = segment_sum(d_card, i_card, n)
    assert KERNEL.launches == before + 2
    want = segment_sum_ref(torch.as_tensor(data), torch.as_tensor(ids).long(), n)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    x = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32))
    xc = x.to(dev).requires_grad_()
    xh = x.clone().requires_grad_()
    (g_card,) = torch.autograd.grad(gather(xc, i_card), xc, d_card)
    (g_cpu,) = torch.autograd.grad(gather(xh, torch.as_tensor(ids)), xh, torch.as_tensor(data))
    assert torch.equal(g_card.cpu().view(torch.int32), g_cpu.view(torch.int32))
    assert torch.equal(g_cpu.view(torch.int32), want.view(torch.int32))
    with pytest.raises(TypeError):
        segment_sum(d_card.double(), i_card, n)


def _stage_rows(f):
    """Rows in one stage of ``csrc/segment_sum.cu``'s long-role ring for
    row width ``f``: a slice of at most 16 columns, each kept as a power of
    two of rows (64 to 256) and 4 floats of padding within 1,152 floats."""
    cw, r = min(f, 16), 256
    while r > 64 and r > 1152 // cw - 4:
        r //= 2
    return r


def _segment_sum_card_and_cpu(dev, data, ids, n):
    """The card's sum, twice (one counted launch each, bit-equal), and the
    plain version's on the CPU."""
    from repro_torch.kernels.segment_sum import KERNEL, segment_sum, segment_sum_ref

    d_card, i_card = torch.as_tensor(data, device=dev), torch.as_tensor(ids, device=dev)
    before = KERNEL.launches
    got = segment_sum(d_card, i_card, n)
    again = segment_sum(d_card, i_card, n)
    assert KERNEL.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    return got.cpu(), segment_sum_ref(torch.as_tensor(data), torch.as_tensor(ids).long(), n)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 4, 32, 33, 128])
def test_cuda_segment_sum_hubs_equal_the_cpu_bit_for_bit(f):
    """A 47,691-edge hub (Twitter's largest), 60 hubs of mixed lengths,
    segments at ``LONG_SEGMENT`` and one edge more, at one and at five ring
    stages (the ring's length) and one edge either side, among 20,000 short
    segments, in shuffled edge order: the card equals the plain version on
    the CPU bit for bit, two launches bit-equal; the gather's backward over
    the same ids too."""
    dev = _cuda_or_skip()
    from repro_torch.kernels.segment_sum import gather
    from repro_torch.kernels.segment_sum.ops import LONG_SEGMENT

    rng = np.random.default_rng(f)
    at, r = LONG_SEGMENT, _stage_rows(f)
    hubs = [47_691, at, at + 1, r - 1, r, r + 1, 5 * r - 1, 5 * r, 5 * r + 1]
    hubs += rng.integers(at + 1, 4_000, size=60).tolist()
    lengths = np.concatenate([hubs, rng.integers(0, 12, size=20_000)])
    ids = np.repeat(np.arange(lengths.size), lengths)
    ids = ids[rng.permutation(ids.size)].astype(np.int32)
    n = lengths.size + 3                                          # empty segments at the end
    data = (rng.standard_normal((ids.size, f)) * np.exp(3 * rng.standard_normal((ids.size, 1)))).astype(np.float32)
    got, want = _segment_sum_card_and_cpu(dev, data, ids, n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    x = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32))
    xc, xh = x.to(dev).requires_grad_(), x.clone().requires_grad_()
    (g_card,) = torch.autograd.grad(gather(xc, torch.as_tensor(ids, device=dev)), xc, torch.as_tensor(data, device=dev))
    (g_cpu,) = torch.autograd.grad(gather(xh, torch.as_tensor(ids)), xh, torch.as_tensor(data))
    assert torch.equal(g_card.cpu().view(torch.int32), g_cpu.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 4, 33, 300])
def test_cuda_segment_sum_every_edge_in_one_segment(f):
    """100,000 edges, all in segment 1 of 3 (300 columns: 19 long blocks
    over the hub): the card equals the plain version on the CPU bit for
    bit."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(100 + f)
    data = (rng.standard_normal((100_000, f)) * np.exp(3 * rng.standard_normal((100_000, 1)))).astype(np.float32)
    got, want = _segment_sum_card_and_cpu(dev, data, np.ones(100_000, np.int64), 3)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not got[0].any() and not got[2].any()


@pytest.mark.cuda
def test_cuda_segment_sum_add_probe():
    """The chain floor's unit: one dependent add takes a few cycles."""
    from repro_torch.kernels.segment_sum.ops import add_cycles

    cycles, ns = add_cycles(_cuda_or_skip())
    assert 1.0 <= cycles <= 64.0 and ns > 0.0
