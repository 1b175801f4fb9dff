"""Port parity for DiDiC.

DiDiC's product ``A_c @ X`` is the JAX package's bit for bit on the CPU:
the port's ``segment_spmm`` rounds each term once and adds a row's terms
in ascending edge order, XLA's CPU order for ``jax.ops.segment_sum``
(``tests/test_torch_segment_spmm.py``). The rest of the step sums float32
in another order than XLA (PyTorch's mean, the elementwise updates as XLA
fuses them), so values agree to a tolerance, not bit for bit. Gaps
measured on the CPU (GIS at scale 0.003, k=4), the same as with the
bucketed product before it, so they come from outside the product:

* one ``didic_refine`` iteration from a carried state: max relative gap
  2.7e-6 on ``w``, 4.3e-6 on ``l``, 1.1e-7 on ``beta`` — held to rtol 1e-4;
* five ``didic_partition`` iterations fed JAX's commit masks: ``parts``
  agree on 100 % of vertices on all three datasets (``w`` within 1.5e-6 to
  2.7e-6) — held to ≥ 99 % (a near-tie in ``argmax`` may flip a vertex);
* 20 iterations from each package's own random stream (filesystem at
  scale 0.001, GIS and Twitter at 0.002): the largest edge-cut gap was
  0.047 (filesystem, k=4: 0.323 vs 0.370) and the largest T_G gap 0.026
  (the same run: 0.150 vs 0.176); both routes gave the same parts —
  held to ``|port − ref| ≤ 0.25·ref + 0.01``, and below random's cut.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.didic import DidicConfig as JaxDidicConfig
from repro.core.didic import didic_partition as jax_didic_partition
from repro.core.didic import didic_refine as jax_didic_refine
from repro.graphs import datasets as jax_datasets
from repro_torch import convert
from repro_torch.core import metrics, partitioners
from repro_torch.core.didic import DidicConfig, didic_partition, didic_refine
from repro_torch.core.traffic import execute_ops, generate_ops
from repro_torch.graphs import datasets

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)


def _jax_commit_masks(seed, n, p, iterations):
    """The masks the JAX package's key schedule draws (didic._run_iterations)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(iterations):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.bernoulli(sub, p, (n,))))
    return out


def test_refine_one_iteration_matches_jax_step():
    g = datasets.load("gis", scale=0.003)
    jg = jax_datasets.load("gis", scale=0.003)
    _, jstate = jax_didic_partition(jg, JaxDidicConfig(k=4, iterations=3), seed=2)
    parts = np.asarray(jstate.parts)
    jparts, jout = jax_didic_refine(jg, parts, JaxDidicConfig(k=4), state=jstate, iterations=1)
    state = convert.didic_state_from_arrays(
        np.asarray(jstate.w), np.asarray(jstate.l), parts, np.asarray(jstate.beta), device="cpu")
    got_parts, out = didic_refine(g, parts, DidicConfig(k=4), state=state, iterations=1, device="cpu")
    for field in ("w", "l", "beta"):
        np.testing.assert_allclose(
            getattr(out, field).numpy(), np.asarray(getattr(jout, field)),
            rtol=1e-4, atol=1e-5, err_msg=field)
    assert (got_parts == np.asarray(jparts)).mean() >= 0.99


@pytest.mark.parametrize("name", ["filesystem", "gis", "twitter"])
def test_partition_five_iterations_with_jax_masks(name):
    g = datasets.load(name, scale=0.003)
    jg = jax_datasets.load(name, scale=0.003)
    cap = 256 if name == "filesystem" else 64
    jparts, _ = jax_didic_partition(jg, JaxDidicConfig(k=4, iterations=5, smooth_cap=cap), seed=0)
    parts, state = didic_partition(
        g, DidicConfig(k=4, iterations=5, smooth_cap=cap), seed=0, device="cpu",
        commit_masks=_jax_commit_masks(0, g.n_nodes, 0.9, 5),
    )
    assert state.w.shape == (g.n_nodes, 4)
    assert (parts == np.asarray(jparts)).mean() >= 0.99


# The kernel route's plain CPU product reads every stored 128x128 block,
# which grows with the square of the filesystem tree's size.
BAND_SCALE = {"filesystem": 0.001, "gis": 0.002, "twitter": 0.002}


def _within_band(port, ref):
    return abs(port - ref) <= 0.25 * ref + 0.01


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["filesystem", "gis", "twitter"])
def test_routes_land_in_the_reference_band(name, k):
    g = datasets.load(name, scale=BAND_SCALE[name])
    jg = jax_datasets.load(name, scale=BAND_SCALE[name])
    cap = 256 if name == "filesystem" else 64
    ops = generate_ops(g, n_ops=60 if name == "gis" else 200, seed=0)
    jparts, _ = jax_didic_partition(jg, JaxDidicConfig(k=k, iterations=20, smooth_cap=cap), seed=0)
    jparts = np.asarray(jparts)
    ref_cut = metrics.edge_cut_fraction(g, jparts)
    ref_tg = execute_ops(g, ops, jparts, k, device="cpu").percent_global
    rnd = partitioners.random_partition(g.n_nodes, k, seed=0)
    rnd_cut = metrics.edge_cut_fraction(g, rnd)
    for use_kernel in (False, True):
        parts, _ = didic_partition(
            g, DidicConfig(k=k, iterations=20, smooth_cap=cap, use_kernel=use_kernel),
            seed=0, device="cpu",
        )
        cut = metrics.edge_cut_fraction(g, parts)
        tg = execute_ops(g, ops, parts, k, device="cpu").percent_global
        assert _within_band(cut, ref_cut), (use_kernel, cut, ref_cut)
        assert _within_band(tg, ref_tg), (use_kernel, tg, ref_tg)
        assert cut < rnd_cut


def test_segment_route_is_run_to_run_deterministic():
    g = datasets.load("twitter", scale=0.002)
    cfg = DidicConfig(k=4, iterations=5)
    p1, s1 = didic_partition(g, cfg, seed=3, device="cpu")
    p2, s2 = didic_partition(g, cfg, seed=3, device="cpu")
    np.testing.assert_array_equal(p1, p2)
    assert s1.w.equal(s2.w)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _two_iterations(spmm, degc, n, k, seed, live=None):
    """Two step calls from a random map (smoothing 4, then the cap), the
    commit masks drawn from ``seed``."""
    from repro_torch.core import didic

    rng = np.random.default_rng(seed)
    parts = torch.as_tensor(rng.integers(0, k, n).astype(np.int32))
    state = didic._init_state(k, parts)
    if live is not None:  # the overlay's seed: zero loads on the dead rows
        state.w = state.l = state.w * live[:, None]
    cfg = DidicConfig(k=k)
    step = didic._make_step(spmm, degc, cfg, live=live, live_n=None if live is None else int(live.sum()))
    w, l, parts, beta = state.w, state.l, state.parts, state.beta
    for depth in (4, cfg.smooth_cap):
        commit = torch.as_tensor(rng.random(n) < 0.9)
        w, l, parts, beta = step(w, l, parts, beta, commit, depth)
    return w, l, parts, beta


@pytest.mark.parametrize("name", ["filesystem", "gis", "twitter"])
def test_fused_step_equals_the_generic_step(name):
    """The step through ``SegmentSpmm``'s fused calls (each update in its
    product's call) against the same step with the product wrapped in a
    plain callable (the eager updates around it): w, l, parts and beta bit
    for bit after two iterations."""
    from repro_torch.core import didic

    g = datasets.load(name, scale=0.003)
    spmm, degc = didic.make_spmm(g, DidicConfig(k=4), device="cpu")
    assert isinstance(spmm, didic.SegmentSpmm)
    fused = _two_iterations(spmm, degc, g.n_nodes, 4, seed=7)
    generic = _two_iterations(lambda x: spmm(x), degc, g.n_nodes, 4, seed=7)
    for field, a, b in zip(("w", "l", "parts", "beta"), fused, generic):
        assert torch.equal(_bits(a), _bits(b)), field


@pytest.mark.parametrize("name", ["filesystem", "twitter"])
def test_fused_overlay_step_equals_the_generic_step(name):
    """The same on the capacity overlay (``n_cap + 1`` rows, the rows past
    ``n_nodes`` dead): bit for bit, the dead rows of w and l exactly 0."""
    from repro_torch.core import didic

    g = datasets.load(name, scale=0.003)
    store = g.ensure_store(headroom=1.5)
    spmm, degc = didic._overlay_tables(g, "cpu")
    n_rows = store.n_cap + 1
    live = torch.arange(n_rows) < g.n_nodes
    fused = _two_iterations(spmm, degc, n_rows, 4, seed=8, live=live)
    generic = _two_iterations(lambda x: spmm(x), degc, n_rows, 4, seed=8, live=live)
    for field, a, b in zip(("w", "l", "parts", "beta"), fused, generic):
        assert torch.equal(_bits(a), _bits(b)), field
    assert not fused[0][g.n_nodes:].any() and not fused[1][g.n_nodes:].any()
