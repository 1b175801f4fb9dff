"""Port parity for the four kernels: frontier gather, block-ELL SpMM,
EmbeddingBag and flash attention.

On the CPU each wrapper runs its plain PyTorch version, which must match
the JAX package's Pallas kernel (interpret mode) and its jnp reference:
min mode bit-exact (a single float32 add and a min are exact in any
order), sum mode and float32 block-ELL products within 1e-5 (float32 sums
taken in another order), bfloat16 block-ELL within 3e-2 (bf16 inputs,
float32 accumulation), EmbeddingBag within 1e-6 (mean mode within 1e-5 of
a Python loop), flash attention within 2e-5 in float32 and 3e-2 in
bfloat16 — the JAX package's own bars (tests/test_traffic_engine.py,
tests/test_kernels.py). The hand-written kernels themselves are tested on
the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import generators as jax_generators
from repro.graphs.structure import padded_neighbors as jax_padded_neighbors
from repro.kernels.bsr_spmm import bell_matmul as jax_bell_matmul
from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag import embedding_bag_ref as jax_embedding_bag_ref
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import mha as jax_mha
from repro.kernels.frontier import frontier_gather as jax_frontier_gather
from repro.kernels.frontier import frontier_gather_ref as jax_frontier_gather_ref
from repro.kernels.frontier import make_frontier_gather as jax_make_frontier_gather
import repro_torch
from repro_torch import convert, kernels
from repro_torch.graphs import generators
from repro_torch.graphs.structure import padded_neighbors
from repro_torch.kernels.bsr_spmm import make_bell_matmul
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_auto
from repro_torch.kernels.embedding_bag import ops as embedding_bag_ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_bwd_ref, embedding_bag_ref
from repro_torch.kernels.embedding_bag.ref import TEST_SHAPES as EMBEDDING_BAG_SHAPES
from repro_torch.kernels.flash_attention import attention_ref, flash_attention, mha
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import TEST_SHAPES as FLASH_SHAPES
from repro_torch.kernels.flash_attention.ref import attention_bwd_lse_ref, attention_bwd_ref, attention_lse_ref
from repro_torch.kernels.frontier import frontier_gather, frontier_relax, make_frontier_gather, spill_tail
from repro_torch.kernels.segment_spmm import csr_matrix, segment_spmm
from repro_torch.kernels.segment_sum import gather, segment_sum

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)


def _layout(seed, n, e, cap=None):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    return (s, r, w), padded_neighbors(s, r, w, n, cap=cap), jax_padded_neighbors(s, r, w, n, cap=cap)


@pytest.mark.parametrize("c", [10, 300])
def test_frontier_gather_plain_matches_pallas(c):
    n = 41
    _, pn, jpn = _layout(0, n, 150)
    x = np.random.default_rng(1).normal(size=(n, c)).astype(np.float32)
    w_sum = pn.w * pn.mask
    w_inf = np.where(pn.mask > 0, pn.w, np.float32(np.inf))
    xt = torch.as_tensor(x)
    nbr = torch.as_tensor(pn.nbr)

    got_min = frontier_gather(xt, nbr, torch.as_tensor(w_inf), mode="min").numpy()
    pallas_min = jax_frontier_gather(
        jnp.asarray(x), jnp.asarray(jpn.nbr), jnp.asarray(w_inf), mode="min", interpret=True)
    ref_min = jax_frontier_gather_ref(
        jnp.asarray(x), jnp.asarray(jpn.nbr), jnp.asarray(jpn.w), jnp.asarray(jpn.mask), mode="min")
    np.testing.assert_array_equal(got_min, np.asarray(pallas_min))
    np.testing.assert_array_equal(got_min, np.asarray(ref_min))

    got_sum = frontier_gather(xt, nbr, torch.as_tensor(w_sum), mode="sum").numpy()
    pallas_sum = jax_frontier_gather(
        jnp.asarray(x), jnp.asarray(jpn.nbr), jnp.asarray(w_sum), mode="sum", interpret=True)
    np.testing.assert_allclose(got_sum, np.asarray(pallas_sum), rtol=1e-5, atol=1e-5)


def test_frontier_gather_min_propagates_nan_like_pallas():
    """NaN and -inf in x (row 0 too, which every padded slot reads with
    weight +inf, so -inf there gives NaN): the plain version's min is
    jnp.minimum's, NaN wherever any x + w is NaN, equal to the Pallas
    kernel in NaN mask and in every other value."""
    n, c = 41, 12
    _, pn, jpn = _layout(0, n, 150)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, c)).astype(np.float32)
    x[0, :3] = [np.nan, -np.inf, np.inf]
    x[rng.random((n, c)) < 0.05] = np.nan
    x[rng.random((n, c)) < 0.05] = -np.inf
    w_inf = np.where(pn.mask > 0, pn.w, np.float32(np.inf))
    got = frontier_gather(torch.as_tensor(x), torch.as_tensor(pn.nbr), torch.as_tensor(w_inf),
                          mode="min").numpy()
    want = np.asarray(jax_frontier_gather(
        jnp.asarray(x), jnp.asarray(jpn.nbr), jnp.asarray(w_inf), mode="min", interpret=True))
    assert (pn.mask == 0).any() and np.isnan(got).any() and np.isneginf(got).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got, nan=0.0), np.nan_to_num(want, nan=0.0))


@pytest.mark.parametrize("mode", ["min", "sum"])
def test_frontier_gather_row_order_changes_nothing(mode):
    """``order`` only schedules rows: with a permutation the result equals
    the call without it (the plain version ignores it), and frontier_relax
    passes it through."""
    n, c = 41, 9
    _, pn, _ = _layout(7, n, 150)
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=(n, c)).astype(np.float32))
    perm = torch.as_tensor(rng.permutation(n).astype(np.int32))
    w = pn.w * pn.mask if mode == "sum" else np.where(pn.mask > 0, pn.w, np.float32(np.inf))
    nbr, w = torch.as_tensor(pn.nbr), torch.as_tensor(w)
    assert torch.equal(frontier_gather(x, nbr, w, mode=mode, order=perm),
                       frontier_gather(x, nbr, w, mode=mode))
    if mode == "min":
        assert torch.equal(frontier_relax(x, nbr, w, None, perm), frontier_gather(x, nbr, w, mode="min"))


@pytest.mark.parametrize("mode", ["min", "sum"])
@pytest.mark.parametrize("cap", [None, 1, 2])
def test_make_frontier_gather_capped_matches_jax(mode, cap):
    n, c = 29, 7
    (s, r, w), pn, jpn = _layout(3, n, 90, cap=cap)
    if cap is not None:
        assert pn.n_spill > 0  # the spill tail is exercised
    x = np.random.default_rng(4).random(size=(n, c)).astype(np.float32)
    got = make_frontier_gather(pn, mode=mode, device="cpu")(torch.as_tensor(x)).numpy()
    carried = convert.padded_neighbors_from_arrays(
        jpn.nbr, jpn.w, jpn.mask, jpn.spill_s, jpn.spill_r, jpn.spill_w)
    np.testing.assert_array_equal(
        make_frontier_gather(carried, mode=mode, device="cpu")(torch.as_tensor(x)).numpy(), got)
    for use_kernel in (False, True):
        want = np.asarray(jax_make_frontier_gather(jpn, mode=mode, use_kernel=use_kernel)(jnp.asarray(x)))
        if mode == "min":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if mode == "min":
        # Cap placement must not change min-mode results at all.
        full = make_frontier_gather(padded_neighbors(s, r, w, n), mode="min", device="cpu")
        np.testing.assert_array_equal(got, full(torch.as_tensor(x)).numpy())


def test_frontier_relax_matches_uncapped_gather():
    n, c = 23, 6
    (s, r, w), pn, _ = _layout(5, n, 120, cap=2)
    x = torch.as_tensor(np.random.default_rng(6).random(size=(n, c)).astype(np.float32))
    w_inf = torch.as_tensor(np.where(pn.mask > 0, pn.w, np.float32(np.inf)))
    got = frontier_relax(
        x, torch.as_tensor(pn.nbr), w_inf, spill_tail(pn.spill_s, pn.spill_r, pn.spill_w, n, "cpu"),
    )
    want = make_frontier_gather(padded_neighbors(s, r, w, n), mode="min", device="cpu")(x)
    assert torch.equal(got, want)


def test_spill_tail_packs_by_receiver():
    """The CSR tail of a shuffled COO spill: row offsets, the rows that have
    a tail, each row's entries in their COO order, and the same relaxation
    as the tail of the sorted COO."""
    n, c = 23, 5
    (s, r, w), pn, _ = _layout(9, n, 120, cap=1)
    perm = np.random.default_rng(10).permutation(pn.n_spill)
    tail = spill_tail(pn.spill_s[perm], pn.spill_r[perm], pn.spill_w[perm], n, "cpu")
    counts = np.bincount(pn.spill_r, minlength=n)
    np.testing.assert_array_equal(tail.ptr.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    np.testing.assert_array_equal(tail.rows.numpy(), np.flatnonzero(counts))
    by_row = np.argsort(pn.spill_r[perm], kind="stable")
    np.testing.assert_array_equal(tail.src.numpy(), pn.spill_s[perm][by_row])
    x = torch.as_tensor(np.random.default_rng(11).random(size=(n, c)).astype(np.float32))
    nbr, w_inf = torch.as_tensor(pn.nbr), torch.as_tensor(np.where(pn.mask > 0, pn.w, np.float32(np.inf)))
    assert torch.equal(frontier_relax(x, nbr, w_inf, tail),
                       frontier_relax(x, nbr, w_inf, spill_tail(pn.spill_s, pn.spill_r, pn.spill_w, n, "cpu")))


@pytest.mark.parametrize("block_size", [16, 32, 128])
@pytest.mark.parametrize("f", [4, 20, 128])
def test_bell_matmul_plain_matches_pallas(block_size, f):
    g = generators.two_cluster(n_per=70, p_in=0.2, p_out=0.02, seed=1)
    bell = g.to_block_ell(block_size=block_size)
    jbell = jax_generators.two_cluster(n_per=70, p_in=0.2, p_out=0.02, seed=1).to_block_ell(block_size)
    x = np.random.default_rng(0).normal(size=(bell.padded_rows, f)).astype(np.float32)
    got = make_bell_matmul(bell, device="cpu")(torch.as_tensor(x)).numpy()
    carried = convert.block_ell_from_arrays(
        jbell.blocks, jbell.block_cols, jbell.block_mask, jbell.n_rows, jbell.n_cols,
        jbell.block_size)
    np.testing.assert_array_equal(
        make_bell_matmul(carried, device="cpu")(torch.as_tensor(x)).numpy(), got)
    want = jax_bell_matmul(
        jnp.asarray(jbell.blocks), jnp.asarray(jbell.block_cols),
        jnp.asarray(jbell.block_mask.astype(np.int32)), jnp.asarray(x),
        block_size=block_size, interpret=True,
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bell_matmul_bf16_matches_pallas():
    g = generators.two_cluster(n_per=32, p_in=0.2, p_out=0.05, seed=2)
    bell = g.to_block_ell(block_size=32)
    x = np.random.default_rng(2).normal(size=(bell.padded_rows, 16)).astype(np.float32)
    got = make_bell_matmul(bell, device="cpu", dtype=torch.bfloat16)(
        torch.as_tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jax_bell_matmul(
        jnp.asarray(bell.blocks, dtype=jnp.bfloat16), jnp.asarray(bell.block_cols),
        jnp.asarray(bell.block_mask.astype(np.int32)), jnp.asarray(x, dtype=jnp.bfloat16),
        block_size=32, interpret=True,
    )
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, dtype=np.float32), rtol=3e-2, atol=3e-2)


def test_cpu_tensors_never_launch_and_cuda_request_raises(monkeypatch):
    kernels.reset_launch_counts()
    _, pn, _ = _layout(0, 17, 40)
    x = torch.rand(17, 5)
    make_frontier_gather(pn, mode="min", device="cpu")(x)
    bell = generators.two_cluster(n_per=8, seed=0).to_block_ell(block_size=16)
    make_bell_matmul(bell, device="cpu")(torch.rand(bell.padded_rows, 3))
    embedding_bag_auto(torch.rand(10, 4), torch.zeros((2, 3), dtype=torch.int32), mode="mean")
    q = torch.rand(4, 8, 16)
    flash_attention(q, q[:2], q[:2])
    mha(torch.rand(1, 8, 4, 16), torch.rand(1, 8, 2, 16), torch.rand(1, 8, 2, 16))
    rows = torch.rand(6, 3, requires_grad=True)
    segment_sum(gather(rows, torch.tensor([0, 5, 5, 2])), torch.tensor([1, 0, 1, 3]), 4).sum().backward()
    segment_spmm(torch.rand(6, 3), csr_matrix(torch.tensor([0, 0, 2]), torch.tensor([4, 0, 5]), torch.rand(3), 4))
    assert kernels.launch_counts() == {
        "frontier_gather": 0, "bell_matmul": 0, "embedding_bag": 0, "flash_attention": 0,
        "flash_attention_bwd": 0, "segment_sum": 0, "segment_spmm": 0}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_frontier_gather(pn, mode="min", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_bell_matmul(bell)


@pytest.mark.parametrize("v,d,b,l", EMBEDDING_BAG_SHAPES)
def test_embedding_bag_plain_matches_pallas(v, d, b, l):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, l)).astype(np.int32)
    w = rng.random((b, l)).astype(np.float32)
    w[:, -1] = 0.0
    got = embedding_bag(torch.as_tensor(table), torch.as_tensor(idx), torch.as_tensor(w)).numpy()
    args = (jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(jax_embedding_bag(*args, interpret=True)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jax_embedding_bag_ref(*args)), rtol=1e-6, atol=1e-6)


def test_embedding_bag_mean_mode_matches_loop():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.integers(0, 50, size=(4, 6)).astype(np.int32)
    mask = (rng.random((4, 6)) > 0.3).astype(np.float32)
    mask[2] = 0.0  # an empty bag pools to zeros
    out = embedding_bag_auto(torch.as_tensor(table), torch.as_tensor(idx), torch.as_tensor(mask),
                             mode="mean").numpy()
    for i in range(4):
        rows = [table[idx[i, j]] for j in range(6) if mask[i, j] > 0]
        expected = np.mean(rows, axis=0) if rows else np.zeros(8)
        np.testing.assert_allclose(out[i], expected, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,qoff", FLASH_SHAPES)
def test_flash_attention_plain_matches_pallas(b, hq, hkv, tq, tk, dh, causal, qoff):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b * hq, tq, dh)).astype(np.float32)
    k = rng.normal(size=(b * hkv, tk, dh)).astype(np.float32)
    v = rng.normal(size=(b * hkv, tk, dh)).astype(np.float32)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                          causal=causal, q_offset=qoff).numpy()
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               q_offset=qoff, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, q_offset=qoff)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16_plain_matches_pallas():
    rng = np.random.default_rng(1)
    arrs = [rng.normal(size=s) for s in ((4, 64, 32), (2, 64, 32), (2, 64, 32))]
    got = flash_attention(*(torch.as_tensor(a, dtype=torch.bfloat16) for a in arrs), causal=True)
    assert got.dtype == torch.bfloat16
    want = jax_flash_attention(*(jnp.asarray(a, dtype=jnp.bfloat16) for a in arrs), causal=True,
                               block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               rtol=3e-2, atol=3e-2)
    want32 = attention_ref(*(torch.as_tensor(a.astype(np.float32)) for a in arrs), causal=True)
    np.testing.assert_allclose(got.float().numpy(), want32.numpy(), rtol=3e-2, atol=3e-2)


def test_mha_layout_matches_jax_kernel_path():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 16, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    got = mha(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), causal=True).numpy()
    assert got.shape == (2, 16, 4, 8)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, use_kernel=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,dh,route,dh_kernel", [
    (torch.bfloat16, 128, "wgmma", 128),
    (torch.bfloat16, 64, "wgmma", 64),
    (torch.bfloat16, 100, "wgmma", 128),
    (torch.bfloat16, 48, "wgmma", 64),
    (torch.bfloat16, 1, "wgmma", 64),
    (torch.float32, 128, "ffma", 128),
    (torch.float32, 48, "ffma", 48),
])
def test_flash_attention_route_by_dtype_and_head_dim(dtype, dh, route, dh_kernel):
    # bfloat16 goes to the tensor cores at a head dim of whole 64-column
    # boxes; float32 stays on the float32 pipe at its own head dim.
    assert flash_ops.plan(dtype, dh) == (route, dh_kernel)


@pytest.mark.parametrize("dh", [48, 100])
def test_flash_attention_head_dim_padding_matches_pallas(monkeypatch, dh):
    """The CUDA branch (route, zero-padding of the head dim, slicing) on CPU
    tensors, with the launch replaced by the plain version at the padded head
    dim and the scale the kernel is given; held to the JAX kernel in
    interpret mode and to float32 attention, bfloat16's 3e-2."""
    calls = []

    def plain_launch(route, q, k, v, out, *, causal, q_offset, scale):
        calls.append((route, q.shape[-1], scale))
        out.copy_(attention_ref(q.float(), k.float(), v.float(), causal=causal, q_offset=q_offset,
                                scale=scale).to(out.dtype))

    monkeypatch.setattr(flash_ops, "_launch", plain_launch)
    rng = np.random.default_rng(4)
    hq, hkv, tq, tk, qoff = 4, 2, 40, 72, 32
    arrs = [rng.normal(size=(n, t, dh)) for n, t in ((hq, tq), (hkv, tk), (hkv, tk))]
    q, k, v = (torch.as_tensor(a, dtype=torch.bfloat16) for a in arrs)
    got = flash_ops._kernel_call(q, k, v, causal=True, q_offset=qoff)
    assert calls == [("wgmma", 64 if dh <= 64 else 128, dh ** -0.5)]
    assert got.shape == q.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    want = jax_flash_attention(*(jnp.asarray(a, dtype=jnp.bfloat16) for a in arrs), causal=True,
                               q_offset=qoff, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               rtol=3e-2, atol=3e-2)
    want32 = attention_ref(*(torch.as_tensor(a.astype(np.float32)) for a in arrs), causal=True,
                           q_offset=qoff)
    np.testing.assert_allclose(got.float().numpy(), want32.numpy(), rtol=3e-2, atol=3e-2)


# ------------------------------------------------------------- backwards
# The JAX package differentiates its oracles (no Pallas kernel has a
# backward). On the card attention's backward is the kernel
# flash_attention_bwd, whose plain version is attention_bwd_lse_ref (from
# the saved output and log-sum-exp); embedding_bag's backward is plain
# PyTorch. Bars: attention within 1e-5 of jax.grad in float32 (sums over
# up to 128 keys in another order);
# the bag's table gradient within 1e-6, the forward's bar (each entry a sum
# of at most L products); its weight gradient within 1e-6 of its largest
# entry, because each entry is a D-term float32 dot product (D up to 130)
# that XLA and PyTorch sum in another order, so its rounding grows with
# the sum's size (measured: 1.3e-6 on entries of ~8 at D 64).
def _attention_inputs(seed, b, hq, hkv, tq, tk, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b * h, t, dh)).astype(np.float32) for h, t in ((hq, tq), (hkv, tk), (hkv, tk))] + [
        rng.normal(size=(b * hq, tq, dh)).astype(np.float32)]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,qoff", FLASH_SHAPES)
def test_attention_bwd_ref_matches_jax_grad(b, hq, hkv, tq, tk, dh, causal, qoff):
    q, k, v, dout = _attention_inputs(5, b, hq, hkv, tq, tk, dh)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_attention_ref(q_, k_, v_, causal=causal, q_offset=qoff),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got = attention_bwd_ref(*(torch.as_tensor(a) for a in (q, k, v, dout)), causal=causal, q_offset=qoff)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


def test_attention_bwd_ref_keeps_bf16_types():
    q, k, v, dout = (torch.as_tensor(a, dtype=torch.bfloat16) for a in _attention_inputs(6, 1, 4, 2, 16, 16, 8))
    dq, dk, dv = attention_bwd_ref(q, k, v, dout)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


@pytest.mark.parametrize("v,d,b,l", EMBEDDING_BAG_SHAPES)
def test_embedding_bag_bwd_ref_matches_jax_grad(v, d, b, l):
    rng = np.random.default_rng(7)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, l)).astype(np.int32)
    idx[0, :2] = 3  # one row twice in a bag: its gradient adds up
    w = rng.random((b, l)).astype(np.float32)
    w[:, -1] = 0.0
    dout = rng.normal(size=(b, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda t_, w_: jax_embedding_bag_ref(t_, jnp.asarray(idx), w_), jnp.asarray(table), jnp.asarray(w))
    want_t, want_w = vjp(jnp.asarray(dout))
    got_t, got_w = embedding_bag_bwd_ref(table.shape, torch.as_tensor(idx), torch.as_tensor(w),
                                         torch.as_tensor(table), torch.as_tensor(dout))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-6, atol=1e-6)
    want_w = np.asarray(want_w)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=0, atol=1e-6 * np.abs(want_w).max())


def test_embedding_bag_grad_through_plain_version():
    """Twin of the JAX package's ``test_grad_through_oracle``: exact."""
    table = torch.ones((10, 4), requires_grad=True)
    (g,) = torch.autograd.grad(embedding_bag_auto(table, torch.tensor([[1, 2]], dtype=torch.int32),
                                                  torch.ones((1, 2))).sum(), (table,))
    assert float(g[1].sum()) == 4.0 and float(g[3].sum()) == 0.0


@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,qoff", FLASH_SHAPES)
def test_flash_attention_function_wiring(monkeypatch, b, hq, hkv, tq, tk, dh, causal, qoff):
    """The CUDA branch's ``autograd.Function`` on CPU tensors, with the
    launches replaced by the plain versions: the forward fills out and lse
    (one launch, with the log-sum-exp), the backward runs the plain o/lse
    backward (one launch of the backward), and the gradients are the plain
    version's autograd (within 1e-5)."""
    launches = []

    def plain_launch_lse(route, q, k, v, out, lse, *, causal, q_offset, scale):
        launches.append(("forward", route))
        o, l = attention_lse_ref(q, k, v, causal=causal, q_offset=q_offset, scale=scale)
        out.copy_(o)
        lse.copy_(l)

    def plain_launch_bwd(route, q, k, v, out, lse, dout, dq, dk, dv, *, causal, q_offset, scale):
        launches.append(("backward", route))
        for dst, g in zip((dq, dk, dv), attention_bwd_lse_ref(q, k, v, out, lse, dout, causal=causal,
                                                             q_offset=q_offset, scale=scale)):
            dst.copy_(g)

    monkeypatch.setattr(flash_ops, "_launch_lse", plain_launch_lse)
    monkeypatch.setattr(flash_ops, "_launch_bwd", plain_launch_bwd)
    arrs = _attention_inputs(8, b, hq, hkv, tq, tk, dh)
    q, k, v = (torch.tensor(a, requires_grad=True) for a in arrs[:3])
    out, lse = flash_ops._FlashAttention.apply(q, k, v, causal, qoff)
    assert launches == [("forward", "ffma")]
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b * hq, tq) and not lse.requires_grad
    got = torch.autograd.grad(out, (q, k, v), torch.as_tensor(arrs[3]))
    assert launches == [("forward", "ffma"), ("backward", "ffma")]
    qr, kr, vr = (torch.tensor(a, requires_grad=True) for a in arrs[:3])
    want = torch.autograd.grad(attention_ref(qr, kr, vr, causal=causal, q_offset=qoff), (qr, kr, vr),
                               torch.as_tensor(arrs[3]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,qoff", FLASH_SHAPES)
def test_attention_lse_ref_matches_jax_oracle(b, hq, hkv, tq, tk, dh, causal, qoff):
    """The plain forward with its log-sum-exp: the output against the JAX
    oracle, the log-sum-exp against ``logsumexp`` of the JAX oracle's scaled,
    masked scores, both within 1e-5 in float32."""
    q, k, v, _ = _attention_inputs(10, b, hq, hkv, tq, tk, dh)
    out, lse = attention_lse_ref(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal, q_offset=qoff)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, q_offset=qoff)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    s = jnp.einsum("bqd,bkd->bqk", jnp.asarray(q), jnp.repeat(jnp.asarray(k), hq // hkv, axis=0)) * dh ** -0.5
    if causal:
        s = jnp.where(jnp.arange(tk)[None, :] <= jnp.arange(tq)[:, None] + qoff, s, -jnp.inf)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b * hq, tq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(s, axis=-1)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,qoff", FLASH_SHAPES)
def test_attention_bwd_lse_ref_matches_jax_grad(b, hq, hkv, tq, tk, dh, causal, qoff):
    """The plain backward from the saved output and log-sum-exp (what the
    hand-written backward computes) against ``jax.grad`` of the JAX oracle,
    within 1e-5 in float32."""
    q, k, v, dout = _attention_inputs(11, b, hq, hkv, tq, tk, dh)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_attention_ref(q_, k_, v_, causal=causal, q_offset=qoff),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    qt, kt, vt = (torch.as_tensor(a) for a in (q, k, v))
    o, lse = attention_lse_ref(qt, kt, vt, causal=causal, q_offset=qoff)
    got = attention_bwd_lse_ref(qt, kt, vt, o, lse, torch.as_tensor(dout), causal=causal, q_offset=qoff)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype,dh,route,dh_kernel", [
    (torch.bfloat16, 16, "wgmma", 64),
    (torch.bfloat16, 32, "wgmma", 64),
    (torch.bfloat16, 64, "wgmma", 64),
    (torch.bfloat16, 128, "wgmma", 128),
    (torch.float32, 48, "ffma", 48),
    (torch.float32, 128, "ffma", 128),
])
def test_flash_attention_bwd_route_and_padding_plan(dtype, dh, route, dh_kernel):
    # The backward takes the tensor cores for bfloat16 at the forward's
    # padded head dim, the float32 pipe for float32 at its own.
    assert flash_ops.plan_bwd(dtype, dh) == (route, dh_kernel)


@pytest.mark.parametrize("dh", [48, 100])
def test_flash_attention_bwd_head_dim_padding(monkeypatch, dh):
    """The backward's CUDA branch on bfloat16 CPU tensors with the launch
    replaced by the plain o/lse backward: one launch on ``"wgmma"`` at the
    padded head dim with the true head dim's scale, gradients in bfloat16 of
    the unpadded shapes, within 3e-2 of the float32 closed form."""
    calls = []

    def plain_launch_bwd(route, q, k, v, out, lse, dout, dq, dk, dv, *, causal, q_offset, scale):
        calls.append((route, q.shape[-1], out.shape[-1], dout.shape[-1], scale))
        for dst, g in zip((dq, dk, dv), attention_bwd_lse_ref(q, k, v, out, lse, dout, causal=causal,
                                                             q_offset=q_offset, scale=scale)):
            dst.copy_(g)

    monkeypatch.setattr(flash_ops, "_launch_bwd", plain_launch_bwd)
    rng = np.random.default_rng(12)
    hq, hkv, tq, tk, qoff = 4, 2, 40, 72, 32
    arrs = [rng.normal(size=(n, t, dh)) for n, t in ((hq, tq), (hkv, tk), (hkv, tk), (hq, tq))]
    q, k, v, dout = (torch.as_tensor(a, dtype=torch.bfloat16) for a in arrs)
    out, lse = attention_lse_ref(q, k, v, causal=True, q_offset=qoff)
    got = flash_ops._bwd_kernel_call(q, k, v, out, lse, dout, causal=True, q_offset=qoff)
    dh_k = 64 if dh <= 64 else 128
    assert calls == [("wgmma", dh_k, dh_k, dh_k, dh ** -0.5)]
    want = attention_bwd_ref(*(torch.as_tensor(a.astype(np.float32)) for a in arrs), causal=True, q_offset=qoff)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape and g.is_contiguous()
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=3e-2, atol=3e-2)


def test_embedding_bag_function_wiring(monkeypatch):
    """The same for ``embedding_bag``: gradients of table and weights equal
    to the plain version's autograd (within 1e-6), one launch forward."""
    launches = []

    def plain_launch(table, indices, weights, out):
        launches.append(tuple(out.shape))
        out.copy_(embedding_bag_ref(table, indices, weights))

    monkeypatch.setattr(embedding_bag_ops, "_launch", plain_launch)
    rng = np.random.default_rng(9)
    table = rng.normal(size=(40, 18)).astype(np.float32)
    idx = torch.as_tensor(rng.integers(0, 40, size=(6, 5)).astype(np.int32))
    w = rng.random((6, 5)).astype(np.float32)
    dout = torch.as_tensor(rng.normal(size=(6, 18)).astype(np.float32))
    t1, w1 = torch.tensor(table, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = torch.autograd.grad(embedding_bag_ops._EmbeddingBag.apply(t1, idx, w1), (t1, w1), dout)
    assert launches == [(6, 18)]
    t2, w2 = torch.tensor(table, requires_grad=True), torch.tensor(w, requires_grad=True)
    want = torch.autograd.grad(embedding_bag_ref(t2, idx, w2), (t2, w2), dout)
    for g, ref in zip(got, want):
        torch.testing.assert_close(g, ref, rtol=1e-6, atol=1e-6)


def test_kernel_library_path_hashes_csrc_headers(tmp_path, monkeypatch):
    """A kernel's cached library is keyed by its source and by every header
    of ``csrc/`` (the attention kernels share ``hopper.cuh``): editing a
    header names a new library, so a stale build is never loaded."""
    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "shared.cuh").write_text("// header\n")
    monkeypatch.setattr(kernels, "_CSRC", tmp_path)
    kernel = kernels.CudaKernel("header_hash_probe", "k.cu", [])
    try:
        before = kernel.library_path()
        assert kernel.library_path() == before
        (tmp_path / "shared.cuh").write_text("// header, edited\n")
        after_header = kernel.library_path()
        assert after_header != before
        (tmp_path / "k.cu").write_text("// kernel, edited\n")
        assert kernel.library_path() not in (before, after_header)
    finally:
        kernels.KERNELS.pop("header_hash_probe", None)
