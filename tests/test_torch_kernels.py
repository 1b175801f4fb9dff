"""Port parity for the two kernels of the first slice.

On the CPU each wrapper runs its plain PyTorch version, which must match
the JAX package's Pallas kernel (interpret mode) and its jnp reference:
min mode bit-exact (a single float32 add and a min are exact in any
order), sum mode and float32 block-ELL products within 1e-5 (float32 sums
taken in another order), bfloat16 block-ELL within 3e-2 (bf16 inputs,
float32 accumulation) — the JAX package's own bars
(tests/test_traffic_engine.py, tests/test_kernels.py). The hand-written
kernels themselves are tested on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import generators as jax_generators
from repro.graphs.structure import padded_neighbors as jax_padded_neighbors
from repro.kernels.bsr_spmm import bell_matmul as jax_bell_matmul
from repro.kernels.frontier import frontier_gather as jax_frontier_gather
from repro.kernels.frontier import frontier_gather_ref as jax_frontier_gather_ref
from repro.kernels.frontier import make_frontier_gather as jax_make_frontier_gather
import repro_torch
from repro_torch import convert, kernels
from repro_torch.graphs import generators
from repro_torch.graphs.structure import padded_neighbors
from repro_torch.kernels.bsr_spmm import make_bell_matmul
from repro_torch.kernels.frontier import frontier_gather, frontier_relax, make_frontier_gather

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


@pytest.mark.parametrize("mode", ["min", "sum"])
@pytest.mark.parametrize("cap", [None, 1, 2])
def test_make_frontier_gather_capped_matches_jax(mode, cap):
    n, c = 29, 7
    (s, r, w), pn, jpn = _layout(3, n, 90, cap=cap)
    if cap is not None:
        assert pn.n_spill > 0  # the spill epilogue is exercised
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
        x, torch.as_tensor(pn.nbr), w_inf, torch.as_tensor(pn.spill_s).long(),
        torch.as_tensor(pn.spill_r).long(), torch.as_tensor(pn.spill_w),
    )
    want = make_frontier_gather(padded_neighbors(s, r, w, n), mode="min", device="cpu")(x)
    assert torch.equal(got, want)


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
    assert kernels.launch_counts() == {"frontier_gather": 0, "bell_matmul": 0}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_frontier_gather(pn, mode="min", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_bell_matmul(bell)
