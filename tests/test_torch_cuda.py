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
