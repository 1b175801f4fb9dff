"""Port parity for the GNN slice: generators, datasets, features, the
neighbour sampler, GCN, GraphSAGE (full and sampled), MeshGraphNet, their
configs and the GNN training launcher, against the JAX package on the CPU.

Inputs come from numpy seeds; weights are drawn by the JAX package and
carried across as numpy (``repro_torch.convert``). Bars, each with its
reason:

* generators, datasets, ``gnn_features``, ``host_shard`` and the sampler's
  blocks: bit-equal (the same numpy draws in the same order);
* forwards: within ``FWD_TOL`` (1e-5) in float32, relative and absolute
  (the segment sums add a node's messages in another order);
* one step's gradients against ``jax.grad``: every leaf within 1e-5 of its
  largest entry;
* the trainer against the JAX trainer at the launcher's configs, with the
  JAX run's DiDiC parts injected (the port's DiDiC is held to the JAX one
  only within a band, and the labels are ``parts % 4``): losses and
  gradient norms within 1e-5 relative over 10 steps. MeshGraphNet's
  config holds that over its first 5 steps only, and all 10 within
  ``DRIFT_RTOL``: at its 7,858 nodes, 4 blocks and ~7.2 M ReLU inputs, one
  input of block 1 lies within float32 rounding of zero in the port's run
  and not in the JAX run, so from step 6 one unit's gradient differs
  discretely (measured: gradient norms 2.9e-5 apart at step 6, losses
  2.45e-4 at step 7, then closer), a difference of rounding that is a
  fault of neither package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import gcn_cora as jax_gcn_cora
from repro.configs import graphsage_reddit as jax_graphsage_reddit
from repro.configs import meshgraphnet as jax_meshgraphnet
from repro.core.didic import DidicConfig as JaxDidicConfig
from repro.core.didic import didic_partition as jax_didic_partition
from repro.data import pipeline as jax_pipeline
from repro.graphs import datasets as jax_datasets
from repro.graphs import generators as jax_generators
from repro.graphs.sampler import NeighborSampler as JaxNeighborSampler
from repro.models import gnn as jax_gnn
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainerConfig as JaxTrainerConfig
from repro_torch import convert
from repro_torch.configs import base, gcn_cora, graphsage_reddit, meshgraphnet
from repro_torch.data import pipeline
from repro_torch.graphs import datasets, generators
from repro_torch.graphs.sampler import NeighborSampler
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn
from repro_torch.optim import adamw
from repro_torch.train.loop import Trainer, TrainerConfig

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_REL = 1e-5
LOSS_RTOL = 1e-5
#: the trainer bar once float32 rounding has flipped a ReLU (module docstring)
DRIFT_RTOL = 1e-2
#: steps a launcher config holds ``LOSS_RTOL`` for before such a flip
EXACT_STEPS = {"gcn-cora": 10, "graphsage-reddit": 10, "meshgraphnet": 5}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _assert_graph_equal(got, want):
    assert got.n_nodes == want.n_nodes and got.name == want.name
    for field in ("senders", "receivers", "edge_weight"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert sorted(got.node_attrs) == sorted(want.node_attrs)
    for k, v in want.node_attrs.items():
        assert got.node_attrs[k].dtype == v.dtype and np.array_equal(got.node_attrs[k], v), k


# ------------------------------------------------------------ graphs, data
@pytest.mark.parametrize("name,args", [
    ("random_graph", dict(n=300, avg_degree=3.9, seed=4)),
    ("grid_graph", dict(rows=7, cols=11)),
    ("molecule_batch", dict(n_mols=5, atoms_per_mol=30, seed=2)),
    ("molecule_batch", dict(n_mols=3, atoms_per_mol=60, edges_per_mol=16, seed=1)),
    ("mesh_graph", dict(rows=9, cols=13, seed=3)),
], ids=["random", "grid", "molecules", "molecules_capped", "mesh"])
def test_generators_bit_equal(name, args):
    _assert_graph_equal(getattr(generators, name)(**args), getattr(jax_generators, name)(**args))


@pytest.mark.parametrize("name,scale", [
    ("cora_like", 1.0), ("cora_like", 0.01), ("reddit_like", 0.01), ("products_like", 0.001),
    ("molecules", 0.1), ("mesh", 0.25),
])
def test_datasets_bit_equal(name, scale):
    _assert_graph_equal(datasets.load(name, scale=scale, seed=1), jax_datasets.load(name, scale=scale, seed=1))


def test_shape_tables_equal_the_jax_package():
    assert datasets.SHAPE_STATS == jax_datasets.SHAPE_STATS
    assert base.GNN_SHAPES == jax_base.GNN_SHAPES


@pytest.mark.parametrize("hint", [False, True], ids=["uniform", "parts_hint"])
def test_gnn_features_bit_equal(hint):
    parts = np.random.default_rng(5).integers(0, 4, size=200) if hint else None
    got = pipeline.gnn_features(200, 24, 7, parts_hint=parts, seed=3)
    want = jax_pipeline.gnn_features(200, 24, 7, parts_hint=parts, seed=3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_host_shard_equals_the_jax_package():
    batch = {"a": np.arange(24).reshape(12, 2), "b": np.arange(12)}
    for i in range(3):
        got, want = pipeline.host_shard(batch, i, 3), jax_pipeline.host_shard(batch, i, 3)
        assert all(np.array_equal(got[k], want[k]) for k in batch)


def test_sampler_blocks_bit_equal():
    g = datasets.load("reddit_like", scale=0.005)
    jg = jax_datasets.load("reddit_like", scale=0.005)
    ns, jns = NeighborSampler(g, (15, 10), seed=2), JaxNeighborSampler(jg, (15, 10), seed=2)
    for nodes, jnodes in zip(ns.batches(64, 3, seed=4), jns.batches(64, 3, seed=4)):
        assert np.array_equal(nodes, jnodes)
        blocks, jblocks = ns.sample_batch(nodes), jns.sample_batch(jnodes)
        assert len(blocks) == len(jblocks) == 2
        for b, jb in zip(blocks, jblocks):
            assert b.n_targets == jb.n_targets
            for field in ("src_nodes", "neighbors", "mask"):
                a, w = getattr(b, field), getattr(jb, field)
                assert a.dtype == w.dtype and np.array_equal(a, w), field
        assert np.array_equal(blocks[0].src_nodes[:blocks[0].n_targets], blocks[1].src_nodes)


def test_sampler_isolated_node_falls_back_to_itself():
    g = convert.graph_from_arrays(3, np.array([0]), np.array([1]), np.ones(1))
    blocks = NeighborSampler(g, (3,), seed=0).sample_batch(np.array([2, 0]))
    assert np.array_equal(blocks[0].src_nodes, [2, 0, 1])
    assert np.array_equal(blocks[0].neighbors, [[0, 0, 0], [2, 2, 2]])
    assert np.array_equal(blocks[0].mask, [[0, 0, 0], [1, 1, 1]])


# ------------------------------------------------------------------ models
def _graph_case(n=120, d=12, seed=0):
    g = generators.random_graph(n, avg_degree=5.0, seed=seed)
    s, r, _ = g.undirected
    x = np.random.default_rng(seed + 1).normal(size=(n, d)).astype(np.float32)
    return g, s, r, x


def _pair(cfg_fields, seed=0):
    """The JAX and port configs and the JAX weights, carried across."""
    jcfg = jax_gnn.GnnConfig(**cfg_fields)
    cfg = gnn.GnnConfig(**cfg_fields)
    jparams = jax_gnn.init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, convert.gnn_params_from_arrays(_np(jparams), cfg.kind, cfg.n_layers, device="cpu")


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def test_segment_primitives_match_jax():
    rng = np.random.default_rng(3)
    data = rng.normal(size=(50, 4)).astype(np.float32)
    ids = rng.integers(0, 9, size=50).astype(np.int32)  # segment 9 of 10 stays empty
    got = gnn.segment_mean(*_t(data), torch.as_tensor(ids).long(), 10).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_gnn.segment_mean(jnp.asarray(data), jnp.asarray(ids), 10)),
                               rtol=FWD_TOL, atol=FWD_TOL)
    _, s, r, _ = _graph_case()
    got = gnn.gcn_norm_coeffs(*(t.long() for t in _t(s, r)), 120).numpy()
    want = np.asarray(jax_gnn.gcn_norm_coeffs(jnp.asarray(s), jnp.asarray(r), 120))
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


GCN = dict(kind="gcn", n_layers=3, d_in=12, d_hidden=16, d_out=5)
SAGE = dict(kind="sage", n_layers=2, d_in=12, d_hidden=16, d_out=5)
MGN = dict(kind="meshgraphnet", n_layers=3, d_in=12, d_hidden=16, d_out=3, d_edge_in=4)


@pytest.mark.parametrize("fields", [GCN, SAGE], ids=["gcn", "sage_full"])
def test_full_graph_forward_matches_jax(fields):
    jcfg, cfg, jparams, params = _pair(fields)
    _, s, r, x = _graph_case()
    jfwd = jax_gnn.gcn_forward if cfg.kind == "gcn" else jax_gnn.sage_forward_full
    fwd = gnn.gcn_forward if cfg.kind == "gcn" else gnn.sage_forward_full
    want = np.asarray(jfwd(jcfg, jparams, jnp.asarray(x), jnp.asarray(s), jnp.asarray(r)))
    got = fwd(cfg, params, *_t(x, s, r)).numpy()
    assert got.shape == (120, 5)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def _sampled_case(seed=0):
    g = generators.twitter_social(scale=0.002, seed=seed)
    x = np.random.default_rng(seed).normal(size=(g.n_nodes, 12)).astype(np.float32)
    labels = np.random.default_rng(seed + 1).integers(0, 5, size=g.n_nodes).astype(np.int32)
    blocks = NeighborSampler(g, (5, 3), seed=seed).sample_batch(np.arange(0, 64, 2))
    return x, labels, blocks


def test_sampled_sage_forward_matches_jax():
    jcfg, cfg, jparams, params = _pair(SAGE)
    x, labels, blocks = _sampled_case()
    want = np.asarray(jax_gnn.sage_forward_sampled(
        jcfg, jparams, [jnp.asarray(x[blocks[0].src_nodes])], [jnp.asarray(b.neighbors) for b in blocks],
        [jnp.asarray(b.mask) for b in blocks], [b.n_targets for b in blocks]))
    got = gnn.sage_forward_sampled(cfg, params, _t(x[blocks[0].src_nodes]), _t(*(b.neighbors for b in blocks)),
                                   _t(*(b.mask for b in blocks)), [b.n_targets for b in blocks]).numpy()
    assert got.shape == (32, 5)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    # The launcher's batch form (the JAX minibatch_lg cell's keys) gives the same outputs' loss.
    b = launch_train.sage_sampled_batch(blocks, *_t(x, labels))
    jloss = jax_gnn.node_classification_loss(jnp.asarray(want), jnp.asarray(labels[np.arange(0, 64, 2)]))
    np.testing.assert_allclose(float(launch_train.gnn_loss(cfg, params, b)), float(jloss), rtol=FWD_TOL)


def test_meshgraphnet_forward_matches_jax():
    jcfg, cfg, jparams, params = _pair(MGN)
    g = generators.mesh_graph(6, 7, seed=1)
    s, r, _ = g.undirected
    rng = np.random.default_rng(2)
    nf = rng.normal(size=(g.n_nodes, 12)).astype(np.float32)
    ef = rng.normal(size=(s.shape[0], 4)).astype(np.float32)
    assert params["proc"]["edge_mlp"]["w0"].shape == (3, 48, 16)
    want = np.asarray(jax_gnn.mgn_forward(jcfg, jparams, *(jnp.asarray(a) for a in (nf, ef, s, r))))
    got = gnn.mgn_forward(cfg, params, *_t(nf, ef, s, r)).numpy()
    assert got.shape == (g.n_nodes, 3)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_node_classification_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(30, 6)).astype(np.float32)
    labels = rng.integers(0, 6, size=30).astype(np.int32)
    mask = (rng.random(30) < 0.5).astype(np.float32)
    for m in (None, mask):
        want = float(jax_gnn.node_classification_loss(jnp.asarray(logits), jnp.asarray(labels),
                                                      None if m is None else jnp.asarray(m)))
        got = float(gnn.node_classification_loss(*_t(logits, labels), None if m is None else torch.as_tensor(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_port_init_shapes_equal_jax_init():
    for fields in (GCN, SAGE, MGN):
        jparams = jax_gnn.init(jax_gnn.GnnConfig(**fields), jax.random.PRNGKey(0))
        params = gnn.init(gnn.GnnConfig(**fields), torch.Generator().manual_seed(0), device="cpu")
        want = {k: v.shape for k, v in _flat(jparams).items()}
        assert {k: tuple(v.shape) for k, v in _flat(params).items()} == want


def test_convert_rejects_a_wrong_tree():
    jparams = _np(jax_gnn.init(jax_gnn.GnnConfig(**MGN), jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="stacked"):
        convert.gnn_params_from_arrays(jparams, "meshgraphnet", 4, device="cpu")
    with pytest.raises(ValueError, match="not a gcn pytree"):
        convert.gnn_params_from_arrays(jparams, "gcn", 3, device="cpu")


# --------------------------------------------------------------- gradients
def _assert_grads_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        a, w = got[key].numpy(), np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        gap = float(np.abs(a.astype(np.float64) - w).max())
        assert gap <= GRAD_REL * scale, f"{what} {key}: max gap {gap:.3g} > {GRAD_REL} x {scale:.3g}"


def _port_grads(loss_fn, params, batch):
    """One step's loss and gradients through the trainer's own gradient
    function (``Trainer._one_grad``)."""
    tr = Trainer(loss_fn, params, adamw.AdamWConfig(), TrainerConfig(total_steps=1))
    loss, grads = tr._one_grad(params, batch)
    return float(loss), _flat(grads)


@pytest.mark.parametrize("fields", [GCN, SAGE, MGN], ids=["gcn", "sage_full", "meshgraphnet"])
def test_gradients_match_jax_grad(fields):
    jcfg, cfg, jparams, params = _pair(fields)
    _, s, r, x = _graph_case()
    labels = np.random.default_rng(9).integers(0, cfg.d_out, size=120).astype(np.int32)
    batch = {"x": x, "labels": labels, "senders": s, "receivers": r}
    if cfg.kind == "meshgraphnet":
        batch["edge_feat"] = np.random.default_rng(4).normal(size=(s.shape[0], 4)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        if cfg.kind == "meshgraphnet":
            return jnp.mean(jax_gnn.mgn_forward(jcfg, p, jb["x"], jb["edge_feat"], jb["senders"], jb["receivers"]) ** 2)
        fwd = jax_gnn.gcn_forward if cfg.kind == "gcn" else jax_gnn.sage_forward_full
        return jax_gnn.node_classification_loss(fwd(jcfg, p, jb["x"], jb["senders"], jb["receivers"]), jb["labels"])

    jl, jg = jax.value_and_grad(jloss)(jparams)
    loss, grads = _port_grads(lambda p, b: launch_train.gnn_loss(cfg, p, b), params,
                              {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss, float(jl), rtol=FWD_TOL)
    _assert_grads_close(grads, _flat(_np(jg)), cfg.kind)


def test_sampled_gradients_match_jax_grad():
    jcfg, cfg, jparams, params = _pair(SAGE)
    x, labels, blocks = _sampled_case(seed=1)
    nodes = np.arange(0, 64, 2)

    def jloss(p):
        out = jax_gnn.sage_forward_sampled(
            jcfg, p, [jnp.asarray(x[blocks[0].src_nodes])], [jnp.asarray(b.neighbors) for b in blocks],
            [jnp.asarray(b.mask) for b in blocks], [b.n_targets for b in blocks])
        return jax_gnn.node_classification_loss(out, jnp.asarray(labels[nodes]))

    jl, jg = jax.value_and_grad(jloss)(jparams)
    loss, grads = _port_grads(lambda p, b: launch_train.gnn_loss(cfg, p, b), params,
                              launch_train.sage_sampled_batch(blocks, *_t(x, labels)))
    np.testing.assert_allclose(loss, float(jl), rtol=FWD_TOL)
    _assert_grads_close(grads, _flat(_np(jg)), "sage_sampled")


# ----------------------------------------------------- configs, launcher
@pytest.mark.parametrize("port,ref,shape", [
    (gcn_cora, jax_gcn_cora, "full_graph_sm"),
    (graphsage_reddit, jax_graphsage_reddit, "minibatch_lg"),
    (meshgraphnet, jax_meshgraphnet, "full_graph_sm"),
], ids=["gcn-cora", "graphsage-reddit", "meshgraphnet"])
def test_full_config_and_smoke(port, ref, shape):
    want = dataclasses.asdict(ref._cfg(jax_base.GNN_SHAPES[shape]))
    got = dataclasses.asdict(port.FULL)
    assert {k: v for k, v in got.items() if k != "dtype"} == {k: v for k, v in want.items()
                                                              if k not in ("dtype", "unroll")}
    assert got["dtype"] == torch.float32 and want["dtype"] == jnp.float32
    metrics = port.smoke(device="cpu")
    assert set(metrics) == set(ref.smoke()) and all(np.isfinite(v) for v in metrics.values())


def _jax_launcher_task(arch):
    """The JAX launcher's GNN task (``repro.launch.train.train_gnn``, lines
    80-102): graph, DiDiC parts, config, weights, edge features, loss."""
    g = jax_datasets.load("gis" if arch == "meshgraphnet" else "cora_like", scale=0.01)
    parts, _ = jax_didic_partition(g, JaxDidicConfig(k=4, iterations=30), seed=0)
    x_np, labels = jax_pipeline.gnn_features(g.n_nodes, 32, 4, parts_hint=parts)
    s, r, _ = g.undirected
    x, y, sj, rj = (jnp.asarray(a) for a in (x_np, labels, s, r))
    kind = launch_train.GNN_KINDS[arch]
    cfg = jax_gnn.GnnConfig(kind=kind, n_layers=2 if kind != "meshgraphnet" else 4,
                            d_in=32, d_hidden=32, d_out=4, d_edge_in=3)
    params = jax_gnn.init(cfg, jax.random.PRNGKey(0))
    ef = jax.random.normal(jax.random.PRNGKey(3), (s.shape[0], 3))

    def loss_fn(p, _):
        if kind == "gcn":
            out = jax_gnn.gcn_forward(cfg, p, x, sj, rj)
        elif kind == "sage":
            out = jax_gnn.sage_forward_full(cfg, p, x, sj, rj)
        else:
            return jnp.mean(jax_gnn.mgn_forward(cfg, p, x, ef, sj, rj) ** 2)
        return jax_gnn.node_classification_loss(out, y)

    return parts, (x_np, labels, s, r), params, ef, loss_fn


@pytest.mark.parametrize("arch", ["gcn-cora", "graphsage-reddit", "meshgraphnet"])
def test_trainer_follows_jax_trainer_at_launcher_config(arch):
    parts, arrays, jparams, ef, jloss = _jax_launcher_task(arch)
    cfg, _, batch = launch_train.gnn_task(arch, device="cpu", parts=parts)
    for key, want in zip(("x", "labels", "senders", "receivers"), arrays):
        assert np.array_equal(batch[key].numpy(), want), key
    if "edge_feat" in batch:
        batch["edge_feat"] = torch.as_tensor(np.array(ef))
    params = convert.gnn_params_from_arrays(_np(jparams), cfg.kind, cfg.n_layers, device="cpu")
    opt = dict(lr=5e-3, warmup_steps=5, total_steps=10, weight_decay=0.0)
    jtr = JaxTrainer(jloss, jparams, JaxAdamWConfig(**opt), JaxTrainerConfig(total_steps=10, log_every=1))
    jtr.fit(iter(lambda: {"_": jnp.zeros(())}, None))
    tr = Trainer(lambda p, b: launch_train.gnn_loss(cfg, p, b), params, adamw.AdamWConfig(**opt),
                 TrainerConfig(total_steps=10, log_every=1))
    tr.fit(iter(lambda: batch, None))
    assert tr.step == jtr.step == 10
    k = EXACT_STEPS[arch]
    for key in ("loss", "grad_norm", "lr"):
        got, want = [m[key] for m in tr.metrics_log], [m[key] for m in jtr.metrics_log]
        np.testing.assert_allclose(got[:k], want[:k], rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(got, want, rtol=DRIFT_RTOL, err_msg=key)
