"""Port parity for the delta-overlay capacity store: ``GraphStore`` and the
growth hooks of ``graphs/structure.py``, the engines and replayers that
adopt grown graphs, the overlay DiDiC step on one device and on a mesh,
the ``apply:compact`` fault site and the store geometry in snapshots.

Held against the JAX package: store geometry (``n_cap``, ``e_cap``,
``base_*``, ``compactions``, ``headroom``) on the same inputs, the
compaction boundaries of the service, one overlay refine iteration with
JAX's commit masks fed in (``w``/``l``/``beta`` within rtol 1e-4, atol
1e-5, ``parts`` equal on ≥ 99 % of vertices, as the storeless step is
held), and the adopted batched and sharded engines' four counters, bit for
bit, against JAX's batched engine on the grown graph. Held within the port:
a crash at ``apply:compact`` recovered bit-exact, cache hits across growth
within capacity at world sizes 1 and 4 (gloo), and the capacity mesh
program reused across growth and in the band of the single-device overlay.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import didic as jax_didic
from repro.core import framework as jax_framework
from repro.core.traffic import execute_ops as jax_execute_ops
from repro.core.traffic import generate_ops as jax_generate_ops
from repro.graphs import datasets as jax_datasets
from repro.graphs import generators as jax_generators
from repro.graphs import structure as jax_structure
from repro_torch import convert
from repro_torch.core import didic, partitioners
from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
from repro_torch.core.dynamism import apply_dynamism
from repro_torch.core.fault import FaultPlan, RetryPolicy, SimulatedCrash
from repro_torch.core.framework import InsertPartitioner, PartitionedGraphService
from repro_torch.core.recovery import DynamismJournal, run_with_recovery
from repro_torch.core.traffic import execute_ops, generate_ops
from repro_torch.core.traffic_batched import BatchedTrafficEngine, get_engine
from repro_torch.graphs import datasets, generators, structure
from repro_torch.graphs.structure import Graph

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")
FAST_DIDIC = didic.DidicConfig(k=4, iterations=6)


def _geometry(store):
    return (store.n_cap, store.e_cap, store.base_nodes, store.base_edges, store.compactions,
            store.headroom)


def _assert_counters_equal(a, b, ctx=""):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{ctx}: {f}")


def _grow(graph, log):
    """``graph`` grown by a vertex-growth log (either package's graph)."""
    return graph.with_vertices(log.n_new_vertices, log.insert_attrs, log.insert_senders,
                               log.insert_receivers, log.insert_weights)


# ---------------------------------------------------------------------------
# Growth headroom (twins of tests/test_graphs.py::TestGrowthHeadroom)
# ---------------------------------------------------------------------------
class TestGrowthHeadroom:
    def test_default_and_explicit_param(self, monkeypatch):
        monkeypatch.delenv("REPRO_GROWTH_HEADROOM", raising=False)
        assert structure.GROWTH_HEADROOM == jax_structure.GROWTH_HEADROOM
        for kw in ({}, {"headroom": 1.25}):
            g = generators.two_cluster(n_per=16, seed=0)
            jg = jax_generators.two_cluster(n_per=16, seed=0)
            st, jst = g.ensure_store(**kw), jg.ensure_store(**kw)
            assert _geometry(st) == _geometry(jst)
            h = kw.get("headroom", structure.GROWTH_HEADROOM)
            assert st.headroom == h
            assert st.n_cap == int(np.ceil(h * g.n_nodes))
            assert st.e_cap == int(np.ceil(h * g.n_edges))
            assert g.ensure_store() is st  # idempotent

    def test_env_var_override_and_validation(self, monkeypatch):
        monkeypatch.setenv("REPRO_GROWTH_HEADROOM", "1.5")
        g, jg = generators.two_cluster(n_per=16, seed=0), jax_generators.two_cluster(n_per=16, seed=0)
        st, jst = g.ensure_store(), jg.ensure_store()
        assert st.headroom == 1.5 and _geometry(st) == _geometry(jst)
        assert st.n_cap == int(np.ceil(1.5 * g.n_nodes))
        # An explicit parameter beats the environment variable.
        assert generators.two_cluster(n_per=16, seed=0).ensure_store(headroom=3.0).headroom == 3.0
        with pytest.raises(ValueError, match=">= 1.0"):
            generators.two_cluster(n_per=16, seed=0).ensure_store(headroom=0.5)
        with pytest.raises(ValueError, match="below current extents"):
            generators.two_cluster(n_per=16, seed=0).ensure_store(n_cap=3)

    def test_compaction_inherits_lineage_headroom(self, monkeypatch):
        grown = []
        for gen in (generators, jax_generators):
            g = gen.two_cluster(n_per=16, seed=0)
            n0 = g.n_nodes
            g.ensure_store(n_cap=n0 + 1, e_cap=g.n_edges + 8, headroom=1.25)
            monkeypatch.setenv("REPRO_GROWTH_HEADROOM", "9.0")  # must be ignored
            g2 = g.with_vertices(2, senders=np.array([n0]), receivers=np.array([0]),
                                 weights=np.array([1.0], np.float32))
            monkeypatch.delenv("REPRO_GROWTH_HEADROOM")
            assert g2.store is not g.store and g2.store.compactions == 1
            assert g2.store.headroom == 1.25
            assert g2.store.n_cap == int(np.ceil(1.25 * g2.n_nodes))
            # An edge insert within the new capacity carries it.
            g3 = g2.with_edges(np.array([0]), np.array([1]))
            assert g3.store is g2.store
            grown.append((_geometry(g2.store), _geometry(g3.store)))
        assert grown[0] == grown[1]


# ---------------------------------------------------------------------------
# Compaction boundaries (twins of tests/test_recovery.py::TestCompactionBoundaries)
# ---------------------------------------------------------------------------
def _fs_pair():
    return (datasets.load("filesystem", scale=0.001, seed=1),
            jax_datasets.load("filesystem", scale=0.001, seed=1))


def _services(g, jg):
    parts = partitioners.random_partition(g.n_nodes, 4, seed=0)
    svc = PartitionedGraphService(g, 4, device="cpu").partition_with(parts.copy())
    jsvc = jax_framework.PartitionedGraphService(jg, 4).partition_with(parts.copy())
    return svc, jsvc


class TestCompactionBoundaries:
    def test_delta_fills_exactly_at_capacity_without_compaction(self):
        g, jg = _fs_pair()
        svc, jsvc = _services(g, jg)
        log = InsertPartitioner("random", 4, seed=0).allocate(svc.parts, 0.05, insert_rate=0.5,
                                                              graph=g)
        nv, ne = log.n_new_vertices, int(log.insert_senders.shape[0])
        assert nv > 0
        store = g.ensure_store(n_cap=g.n_nodes + nv, e_cap=g.n_edges + ne)
        jstore = jg.ensure_store(n_cap=jg.n_nodes + nv, e_cap=jg.n_edges + ne)
        svc.apply_dynamism(log)
        jsvc.apply_dynamism(log)
        assert svc.graph.store is store and store.compactions == 0
        assert store.delta_nodes(svc.graph) == nv and store.delta_edges(svc.graph) == ne
        assert not store.would_overflow(svc.graph, 0, 0) and store.would_overflow(svc.graph, 1, 0)
        assert _geometry(store) == _geometry(jstore)
        # The next growth log would overflow: ``apply:compact`` fires before
        # anything changes.
        log2 = InsertPartitioner("random", 4, seed=1).allocate(svc.parts, 0.05, insert_rate=0.5,
                                                               graph=svc.graph)
        full, parts = svc.graph, svc.parts.copy()
        svc.fault_plan = FaultPlan().crash(0, site="apply:compact")
        svc.fault_plan.begin_slice(0)
        with pytest.raises(SimulatedCrash, match="apply:compact"):
            svc.apply_dynamism(log2)
        assert svc.graph is full and np.array_equal(svc.parts, parts)
        assert full.store is store and store.compactions == 0

    def test_overflow_compacts_then_lands_in_fresh_delta(self):
        g, jg = _fs_pair()
        svc, jsvc = _services(g, jg)
        ip = InsertPartitioner("random", 4, seed=0)
        log = ip.allocate(svc.parts, 0.05, insert_rate=0.5, graph=g)
        caps = dict(n_cap=g.n_nodes + log.n_new_vertices,
                    e_cap=g.n_edges + int(log.insert_senders.shape[0]))
        old = g.ensure_store(**caps)
        jg.ensure_store(**caps)
        svc.apply_dynamism(log)
        jsvc.apply_dynamism(log)
        log2 = ip.allocate(svc.parts, 0.05, insert_rate=0.5, graph=svc.graph)
        assert log2.n_new_vertices > 0
        svc.apply_dynamism(log2)
        jsvc.apply_dynamism(log2)
        new = svc.graph.store
        assert new is not old and new.compactions == old.compactions + 1 == 1
        assert new.n_cap >= svc.graph.n_nodes and new.e_cap >= svc.graph.n_edges
        assert new.delta_nodes(svc.graph) == log2.n_new_vertices
        assert new.delta_edges(svc.graph) == int(log2.insert_senders.shape[0])
        assert old.compactions == 0
        assert _geometry(new) == _geometry(jsvc.graph.store)

    def test_mid_compaction_crash_recovers_bit_exact(self):
        """A crash at ``apply:compact``: the entry is rolled back, the store
        geometry comes back from the snapshot and the re-run compacts as
        the uninterrupted run did; every counter equal on every slice."""
        g = datasets.load("filesystem", scale=0.001, seed=1)

        def make():
            # Tiny headroom: the first growth slice overflows.
            g.ensure_store(n_cap=g.n_nodes + 4, e_cap=g.n_edges + 16)
            svc = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu")
            svc.partition_didic(seed=0)
            return DynamicExperimentRuntime(svc, insert_method="least_traffic", seed=7)

        ops = generate_ops(g, n_ops=60, seed=3)
        kw = dict(maintain_every=2, insert_rate=0.5)
        base = {}
        ref = make()
        want = ref.run(ops, 3, 0.05, on_slice=lambda i, r: base.__setitem__(i, r), **kw)
        assert ref.service.graph.store.compactions >= 1
        got = {}
        out, stats = run_with_recovery(
            make, g, ops, 3, 0.05, fault_plan=FaultPlan().crash(0, site="apply:compact"),
            journal=DynamismJournal(), retry_policy=RetryPolicy(sleep=lambda s: None),
            snapshot_every=2, on_slice=lambda i, r: got.__setitem__(i, r), **kw)
        assert stats.recoveries == 1 and stats.journal_rolled_back >= 1
        for i in range(3):
            _assert_counters_equal(base[i], got[i], f"slice {i}")
        np.testing.assert_array_equal(want.parts, out.parts)
        assert want.records == out.records


# ---------------------------------------------------------------------------
# The overlay DiDiC step against the JAX package's
# ---------------------------------------------------------------------------
def _jax_commit_masks(seed, n, p, iterations):
    """The masks the JAX package's key schedule draws (didic._overlay_refine)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(iterations):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.bernoulli(sub, p, (n,))))
    return out


def _assert_state_close(out, jout, ctx):
    for field in ("w", "l", "beta"):
        np.testing.assert_allclose(getattr(out, field).numpy(), np.asarray(getattr(jout, field)),
                                   rtol=1e-4, atol=1e-5, err_msg=f"{ctx}: {field}")


@pytest.mark.parametrize("when", ["larger_store", "after_growth"])
def test_overlay_refine_matches_jax(when):
    g, jg = datasets.load("gis", scale=0.003), jax_datasets.load("gis", scale=0.003)
    _, jstate = jax_didic.didic_partition(jg, jax_didic.DidicConfig(k=4, iterations=3), seed=2)
    parts = np.asarray(jstate.parts)
    g.ensure_store()
    jg.ensure_store()
    if when == "after_growth":
        log = InsertPartitioner("random", 4, seed=0).allocate(parts, 0.05, insert_rate=0.5, graph=g)
        n0 = g.n_nodes
        g, jg = _grow(g, log), _grow(jg, log)
        assert g.store.n_cap == jg.store.n_cap > g.n_nodes > n0
        parts = apply_dynamism(parts, log)
        assert parts.shape[0] == g.n_nodes
    n_rows = g.store.n_cap + 1
    # A capacity-shaped JAX state (one cold overlay iteration), carried into
    # one more iteration by both packages.
    jparts0, jstate = jax_didic.didic_refine(jg, parts, jax_didic.DidicConfig(k=4), iterations=1)
    parts0 = np.asarray(jparts0)
    jparts, jout = jax_didic.didic_refine(jg, parts0, jax_didic.DidicConfig(k=4), state=jstate,
                                          iterations=1, seed=3)
    state = convert.didic_state_from_arrays(np.asarray(jstate.w), np.asarray(jstate.l),
                                            np.asarray(jstate.parts), np.asarray(jstate.beta),
                                            device="cpu")
    got, out = didic.didic_refine(g, parts0, didic.DidicConfig(k=4), state=state, iterations=1,
                                  seed=3, device="cpu",
                                  commit_masks=_jax_commit_masks(3, n_rows, 1.0, 1))
    assert out.w.shape == (n_rows, 4) and got.shape == (g.n_nodes,)
    _assert_state_close(out, jout, when)
    assert (got == np.asarray(jparts)).mean() >= 0.99
    # Dead rows hold exactly zero. The cold port iteration (no JAX state)
    # lands on JAX's too; its beta is left out: the balance fit counts
    # argmax winners, and a near-tie there moves beta by ~5e-4.
    assert not out.w[g.n_nodes:].any() and not out.l[g.n_nodes:].any()
    got0, out0 = didic.didic_refine(g, parts, didic.DidicConfig(k=4), iterations=1, device="cpu")
    for field in ("w", "l"):
        np.testing.assert_allclose(getattr(out0, field).numpy(), np.asarray(getattr(jstate, field)),
                                   rtol=1e-4, atol=1e-5, err_msg=f"{when}, cold: {field}")
    assert (got0 == parts0).mean() >= 0.99


def test_overlay_refine_repeats_and_reseeds():
    """Two runs are bit-identical; a state of another shape (the storeless
    step's, or across a compaction) is reseeded, as a cold start; the tables
    are built once per graph and dropped before their successor."""
    g = datasets.load("twitter", scale=0.003)
    cfg = didic.DidicConfig(k=4, iterations=3)
    parts, state = didic.didic_partition(g, cfg, seed=1, device="cpu")
    store = g.ensure_store()
    cold = didic.didic_refine(g, parts, cfg, iterations=2, device="cpu")
    again = didic.didic_refine(g, parts, cfg, iterations=2, device="cpu")
    reseeded = didic.didic_refine(g, parts, cfg, state=state, iterations=2, device="cpu")
    for a in (again, reseeded):
        np.testing.assert_array_equal(a[0], cold[0])
        for f in ("w", "l", "parts", "beta"):
            assert torch.equal(getattr(a[1], f), getattr(cold[1], f)), f
    key = ("didic_tables", "cpu")
    tables = store.caches[key]
    g2 = g.with_edges(np.array([0]), np.array([1]))
    didic.didic_refine(g2, parts, cfg, state=cold[1], iterations=1, device="cpu")
    assert g2.store is store and store.caches[key] is not tables
    assert store.caches[key][1] == (g2.n_nodes, g2.n_edges)
    # The kernel route keeps the per-graph packing: its state has N rows.
    _, kst = didic.didic_refine(g2, parts, didic.DidicConfig(k=4, use_kernel=True), iterations=1,
                                device="cpu")
    assert kst.w.shape == (g2.n_nodes, 4)


# ---------------------------------------------------------------------------
# Adopted engines against the JAX package's batched engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["filesystem", "gis", "twitter"])
def test_adopted_engine_counters_match_jax(name):
    g, jg = datasets.load(name, scale=0.002), jax_datasets.load(name, scale=0.002)
    g.ensure_store()
    jg.ensure_store()
    ops = generate_ops(g, n_ops=60 if name == "gis" else 200, seed=1)
    jops = jax_generate_ops(jg, n_ops=60 if name == "gis" else 200, seed=1)
    parts = partitioners.random_partition(g.n_nodes, 4, seed=0).astype(np.int32)
    eng = get_engine(g, ops.pattern, device="cpu")
    _assert_counters_equal(eng.run(ops, parts, 4, ops.t_l, ops.t_pg),
                           jax_execute_ops(jg, jops, parts, 4, engine="batched"), "base")
    ip = InsertPartitioner("random", 4, seed=0)
    for i in range(2):
        log = ip.allocate(parts, 0.05, insert_rate=0.5, graph=g)
        g, jg = _grow(g, log), _grow(jg, log)
        parts = apply_dynamism(parts, log)
        assert get_engine(g, ops.pattern, device="cpu") is eng and eng.n_nodes == g.n_nodes
        got = eng.run(ops, parts, 4, ops.t_l, ops.t_pg)
        _assert_counters_equal(got, jax_execute_ops(jg, jops, parts, 4, engine="batched"),
                               f"slice {i}")
    bare = Graph(n_nodes=g.n_nodes, senders=g.senders, receivers=g.receivers,
                 edge_weight=g.edge_weight, node_attrs=g.node_attrs, name=g.name)
    _assert_counters_equal(got, BatchedTrafficEngine(bare, ops.pattern, device="cpu").run(
        ops, parts, 4, ops.t_l, ops.t_pg), "fresh storeless engine")
    assert eng._n_rows == g.store.n_cap + 1
    # Restarting from the (smaller) base graph adopts back, and matches.
    base = datasets.load(name, scale=0.002)
    base.store = g.store
    p0 = parts[: base.n_nodes]
    _assert_counters_equal(get_engine(base, ops.pattern, device="cpu").run(ops, p0, 4, ops.t_l,
                                                                           ops.t_pg),
                           execute_ops(base, ops, p0, 4, engine="scalar"), "re-adopted base")


# ---------------------------------------------------------------------------
# Caches across growth and the capacity mesh program, at world sizes 1 and 4
# ---------------------------------------------------------------------------
_SCENARIO = textwrap.dedent('''
    import numpy as np
    import torch

    from repro_torch.core import didic, partitioners
    from repro_torch.core.didic_distributed import didic_refine_distributed
    from repro_torch.core.dynamism import apply_dynamism
    from repro_torch.core.framework import InsertPartitioner, PartitionedGraphService
    from repro_torch.core.metrics import edge_cut_fraction
    from repro_torch.core.traffic import generate_ops
    from repro_torch.core.traffic_batched import execute_ops_batched, get_engine
    from repro_torch.core.traffic_sharded import get_replayer
    from repro_torch.graphs import datasets
    from repro_torch.graphs.structure import Graph

    FIELDS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")


    def equal(a, b):
        return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


    def bare(g):
        return Graph(n_nodes=g.n_nodes, senders=g.senders, receivers=g.receivers,
                     edge_weight=g.edge_weight, node_attrs=g.node_attrs, name=g.name)


    def run_cases(mesh, save):
        out = {"world": mesh.size}
        for name, pattern, n_ops in (("filesystem", "filesystem", 101), ("gis", "gis_short", 40)):
            g = datasets.load(name, scale=0.004)
            store = g.ensure_store()
            svc = PartitionedGraphService(g, 4, mesh=mesh)
            svc.partition_with(partitioners.random_partition(g.n_nodes, 4, seed=0).astype(np.int32))
            ops = generate_ops(g, n_ops=n_ops, seed=1, pattern=pattern)
            svc.run_ops(ops)                       # builds and caches on the store
            rep0 = get_replayer(g, pattern, mesh)
            eng0 = get_engine(g, pattern, device="cpu")
            log = InsertPartitioner("random", 4, seed=0).allocate(
                svc.parts, 0.05, insert_rate=0.5, graph=svc.graph)
            svc.apply_dynamism(log)                # grows within capacity
            g2 = svc.graph
            out[f"{name}_grew"] = g2 is not g and g2.n_nodes > g.n_nodes
            out[f"{name}_carried"] = g2.store is store and store.compactions == 0
            out[f"{name}_replayer_hit"] = get_replayer(g2, pattern, mesh) is rep0
            out[f"{name}_engine_hit"] = get_engine(g2, pattern, device="cpu") is eng0
            out[f"{name}_param_keyed"] = (
                get_replayer(g2, pattern, mesh, chunk=7) is not rep0
                and get_engine(g2, pattern, chunk=7, device="cpu") is not eng0
                and get_replayer(g2, pattern, mesh) is rep0)
            got = svc.run_ops(ops)                 # resident state adopted with the replayer
            out[f"{name}_grown_equal"] = (
                equal(got, execute_ops_batched(bare(g2), ops, svc.parts, 4, device="cpu"))
                and equal(got, svc.run_ops(ops, resident=False)))
            save(f"{name}_grown", got)
            save_arrays = {"n_nodes": np.array([g2.n_nodes]), "senders": g2.senders,
                           "receivers": g2.receivers, "edge_weight": g2.edge_weight,
                           "parts": svc.parts}
            for key, val in g2.node_attrs.items():
                save_arrays["attr__" + key] = val
            save(f"{name}_graph", save_arrays)
            # A compaction retires the store: the state moves to the new
            # lineage's replayer, built once.
            log = InsertPartitioner("random", 4, seed=1).allocate(
                svc.parts, 1.0, insert_rate=1.0, graph=svc.graph)
            svc.apply_dynamism(log)
            g3 = svc.graph
            got = svc.run_ops(ops)
            out[f"{name}_compacted"] = (
                g3.store is not store and g3.store.compactions == 1
                and get_replayer(g3, pattern, mesh) is not rep0
                and equal(got, execute_ops_batched(bare(g3), ops, svc.parts, 4, device="cpu")))

        # The capacity mesh program, reused across growth.
        g = datasets.load("twitter", scale=0.004)
        cfg = didic.DidicConfig(k=4, iterations=5)
        parts, _ = didic.didic_partition(g, cfg, seed=0, device="cpu")
        store = g.ensure_store()
        key = ("mesh_program", mesh, ("data",))
        p1, st1 = didic_refine_distributed(g, parts, cfg, mesh, iterations=2)
        prog = store.caches[key]
        again, _ = didic_refine_distributed(g, parts, cfg, mesh, iterations=2)
        log = InsertPartitioner("random", 4, seed=0).allocate(p1, 0.05, insert_rate=0.5, graph=g)
        g2 = g.with_vertices(log.n_new_vertices, log.insert_attrs, log.insert_senders,
                             log.insert_receivers, log.insert_weights)
        grown_parts = apply_dynamism(p1, log)
        p2, st2 = didic_refine_distributed(g2, grown_parts, cfg, mesh, state=st1, iterations=2)
        cold, _ = didic_refine_distributed(g2, grown_parts, cfg, mesh, iterations=2)
        single, _ = didic.didic_refine(g2, grown_parts, cfg, iterations=2, device="cpu")
        out["mesh_program_reused"] = (g2.store is store and store.caches[key] is prog
                                      and prog.extents == (g2.n_nodes, g2.n_edges))
        out["mesh_state_block"] = st2.w.shape[0] == prog.layout.block
        out["mesh_deterministic"] = bool(np.array_equal(p1, again))
        out["mesh_valid"] = bool(p2.shape[0] == g2.n_nodes and 0 <= p2.min() and p2.max() < 4)
        out["mesh_cut"] = edge_cut_fraction(g2, cold)
        out["single_cut"] = edge_cut_fraction(g2, single)
        out["mesh_agree"] = float((cold == single).mean())
        return out
''')

_SPAWN = textwrap.dedent('''
    import json, os, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, world, store_path, out_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        try:
            from repro_torch.launch.mesh import make_replay_mesh
            ns = {}
            exec(open(os.path.join(out_dir, "scenario.py")).read(), ns)
            saved = {}
            out = ns["run_cases"](make_replay_mesh(device="cpu"), _saver(ns, saved))
            if rank == 0:
                np.savez(os.path.join(out_dir, "saved.npz"), **saved)
                print(json.dumps(out), flush=True)
        finally:
            dist.destroy_process_group()

    def _saver(ns, saved):
        def save(key, res):
            items = res.items() if isinstance(res, dict) else (
                (f, getattr(res, f)) for f in ns["FIELDS"])
            for f, val in items:
                saved[f"{key}/{f}"] = val
        return save

    if __name__ == "__main__":
        world, out_dir = int(sys.argv[1]), sys.argv[2]
        mp.spawn(rank_main, args=(world, os.path.join(out_dir, "store"), out_dir), nprocs=world)
''')


def _spawn(world, tmp):
    (tmp / "scenario.py").write_text(_SCENARIO)
    (tmp / "spawn.py").write_text(_SPAWN)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(tmp / "spawn.py"), str(world), str(tmp)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), dict(np.load(tmp / "saved.npz"))


@pytest.fixture(scope="module", params=[1, 4], ids=lambda s: f"S{s}")
def suite(request, tmp_path_factory):
    world = request.param
    if world == 4:
        return _spawn(4, tmp_path_factory.mktemp("store4"))
    from repro_torch.launch.mesh import make_replay_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        ns = {}
        exec(_SCENARIO, ns)
        saved = {}

        def save(key, res):
            items = res.items() if isinstance(res, dict) else (
                (f, getattr(res, f)) for f in ns["FIELDS"])
            for f, val in items:
                saved[f"{key}/{f}"] = val

        return ns["run_cases"](make_replay_mesh(device="cpu"), save), saved
    finally:
        dist.destroy_process_group()


class TestStoreCaches:
    def test_world_size(self, suite, request):
        assert suite[0]["world"] == request.node.callspec.params["suite"]

    @pytest.mark.parametrize("name", ["filesystem", "gis"])
    def test_cache_hits_across_growth(self, suite, name):
        out = suite[0]
        assert out[f"{name}_grew"] and out[f"{name}_carried"]
        assert out[f"{name}_replayer_hit"] and out[f"{name}_engine_hit"]
        assert out[f"{name}_param_keyed"]

    @pytest.mark.parametrize("name", ["filesystem", "gis"])
    def test_adopted_replayer_matches_jax_batched(self, suite, name):
        """The adopted sharded replay (resident state carried through the
        store) against a fresh batched engine and JAX's batched engine on
        the grown graph, bit for bit."""
        out, saved = suite
        assert out[f"{name}_grown_equal"]
        pre = f"{name}_graph/"
        attrs = {k[len(pre) + 6:]: v for k, v in saved.items() if k.startswith(pre + "attr__")}
        jg = jax_structure.Graph(n_nodes=int(saved[pre + "n_nodes"][0]),
                                 senders=saved[pre + "senders"], receivers=saved[pre + "receivers"],
                                 edge_weight=saved[pre + "edge_weight"], node_attrs=attrs,
                                 name=name)
        pattern, n_ops = ("filesystem", 101) if name == "filesystem" else ("gis_short", 40)
        base = jax_datasets.load(name, scale=0.004)
        jops = jax_generate_ops(base, n_ops=n_ops, seed=1, pattern=pattern)
        want = jax_execute_ops(jg, jops, saved[pre + "parts"], 4, engine="batched")
        for f in COUNTERS:
            np.testing.assert_array_equal(saved[f"{name}_grown/{f}"], getattr(want, f), err_msg=f)

    @pytest.mark.parametrize("name", ["filesystem", "gis"])
    def test_compaction_moves_the_state(self, suite, name):
        assert suite[0][f"{name}_compacted"]

    def test_capacity_mesh_program_reused(self, suite):
        out = suite[0]
        assert out["mesh_program_reused"] and out["mesh_state_block"]
        assert out["mesh_deterministic"] and out["mesh_valid"]

    def test_capacity_mesh_refine_in_the_overlay_band(self, suite):
        """Both cold from the same map, two iterations."""
        out = suite[0]
        ref = out["single_cut"]
        assert abs(out["mesh_cut"] - ref) <= 0.25 * ref + 0.01, out
        if out["world"] == 1:
            # One rank: the overlay step on the halo product, summed in
            # another order than the segment route.
            assert out["mesh_agree"] >= 0.99, out
