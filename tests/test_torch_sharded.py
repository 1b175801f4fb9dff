"""The port's sharded replay over a process group, against its batched
engine and the JAX package.

``replay_sharded`` over a ``torch.distributed`` group is held bit for bit
to the port's batched engine on all four counters, at world sizes 1 to 4:
one rank in-process (a gloo group of size 1 over a ``HashStore``), and
2, 3 and 4 gloo ranks started by ``torch.multiprocessing.spawn`` over a
``FileStore`` in a subprocess. The cases are the twins of the JAX
package's sharded-replay suite (``tests/test_traffic_sharded.py``) minus
its store-cache checks: both BFS patterns and both GIS patterns, uneven
and idle shards, delta stepping, the int32-wave / int64-host boundary, the
whole-graph redo pass, resident replay across partition maps, the dirty-set
redo, an authoritative ``max_expansions``, structural-insert invalidation,
and resident states migrated across vertex growth; then degraded mode and
the fault plan's shard failures on a mesh service. The port's batched
engine is held to the JAX package's batched engine on the same cases, and
the port's four-rank replay to the JAX package's cold ``replay_sharded``
on four forced CPU devices.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")

# The scenarios every rank runs (same program, same inputs). ``run_cases``
# returns rank 0's checks; ``save`` writes rank 0's counters for the JAX
# comparisons.
_SCENARIOS = textwrap.dedent('''
    import numpy as np

    from repro_torch.core import partitioners
    from repro_torch.core import traffic_sharded
    from repro_torch.core.dynamism import DynamismLog, apply_dynamism, generate_dynamism
    from repro_torch.core.fault import FaultPlan
    from repro_torch.core.framework import InsertPartitioner, PartitionedGraphService
    from repro_torch.core.traffic import OpLog, generate_ops
    from repro_torch.core.traffic_batched import execute_ops_batched
    from repro_torch.core.traffic_sharded import (
        ShardedTrafficReplayer, get_replayer, migrate_resident_states, replay_sharded,
    )
    from repro_torch.graphs import datasets
    from repro_torch.graphs.structure import Graph

    FIELDS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")
    CASES = [
        ("filesystem", "filesystem", 403, {}),
        ("twitter", "twitter", 401, {}),
        ("gis", "gis_short", 157, {}),
        ("gis", "gis_long", 45, {}),
        ("gis", "gis_short", 10, {"chunk": 4}),        # most ranks idle
        ("gis", "gis_short", 64, {"delta_scale": 4.0}),
    ]


    def equal(a, b):
        return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


    def batched(g, ops, parts, k, **kw):
        return execute_ops_batched(g, ops, parts, k, device="cpu", **kw)


    def detour_graph():
        # src/dst close in space, the only route up a long chain: the
        # windowed pass rejects, the whole-graph redo pass solves.
        pts = ([(0.0, float(y)) for y in range(0, 61)]
               + [(float(x), 60.0) for x in range(1, 3)]
               + [(2.0, float(y)) for y in range(59, -1, -1)]
               + [(0.1 * i, -0.5) for i in range(20)])
        pts = np.array(pts, dtype=np.float32)
        chain_len, blob0 = 63 + 60, 123
        es, er = list(range(chain_len - 1)), list(range(1, chain_len))
        es += list(range(blob0, blob0 + 19)) + [0]
        er += list(range(blob0 + 1, blob0 + 20)) + [blob0]
        ew = np.hypot(*(pts[er] - pts[es]).T).astype(np.float32)
        g = Graph(n_nodes=pts.shape[0], senders=np.array(es, np.int64),
                  receivers=np.array(er, np.int64), edge_weight=ew, name="detour")
        g.node_attrs["lon"] = pts[:, 0].astype(np.float64)
        g.node_attrs["lat"] = pts[:, 1].astype(np.float64)
        dst = chain_len - 1
        ops = OpLog("gis_short",
                    np.array([0, blob0, blob0 + 2, 0, blob0 + 5, 1], np.int64),
                    np.array([dst, blob0 + 10, blob0 + 4, blob0 + 19, dst, dst], np.int64),
                    t_l=8, t_pg=1)
        return g, ops, dst


    def run_cases(mesh, save):
        out = {"world": mesh.size}

        # --- every pattern; op counts leave the shards uneven ------------
        for name, pattern, n_ops, kw in CASES:
            g = datasets.load(name, scale=0.004)
            ops = generate_ops(g, n_ops=n_ops, seed=1, pattern=pattern)
            parts = partitioners.random_partition(g.n_nodes, 4, seed=0)
            got = replay_sharded(g, ops, mesh, parts, 4, **kw)
            cold = replay_sharded(g, ops, mesh, parts, 4, resident=False, **kw)
            key = f"{pattern}_{n_ops}"
            out[key] = equal(got, batched(g, ops, parts, 4, **kw)) and equal(got, cold)
            save(key, got)

        # --- against the scalar oracle (the JAX suite's kernel-path case) -
        from repro_torch.core.traffic import execute_ops
        g = datasets.load("gis", scale=0.0012)
        ops = generate_ops(g, n_ops=16, seed=2, pattern="gis_short")
        parts = partitioners.random_partition(g.n_nodes, 3, seed=1)
        out["scalar_oracle"] = equal(replay_sharded(g, ops, mesh, parts, 3, chunk=8),
                                     execute_ops(g, ops, parts, 3, engine="scalar"))

        # --- int32 device wave -> int64 host fold -------------------------
        # Star graph, every op 2 hops from the hub: the hub's per-vertex
        # traffic 2·d·n_ops > 2^31; a small wave budget forces many waves.
        d, n_ops = 60_000, 20_000
        star = Graph(n_nodes=d + 1, senders=np.zeros(d, dtype=np.int64),
                     receivers=np.arange(1, d + 1, dtype=np.int64),
                     edge_weight=np.ones(d, dtype=np.float32), name="star")
        ops = OpLog("twitter", np.zeros(n_ops, np.int64), np.full(n_ops, -1, np.int64),
                    t_l=2, t_pg=1)
        parts = (np.arange(d + 1) % 4).astype(np.int64)
        budget = traffic_sharded._WAVE_BUDGET
        traffic_sharded._WAVE_BUDGET = 1 << 26
        try:
            got = replay_sharded(star, ops, mesh, parts, 4)
            waves = len(traffic_sharded.bfs_wave_ranges(np.full(n_ops, d, np.int64)))
        finally:
            traffic_sharded._WAVE_BUDGET = budget
        pv_want = np.full(d + 1, n_ops, dtype=np.int64)
        pv_want[0] = 2 * d * n_ops
        out["int64_waves"] = waves
        out["int64_boundary_exceeds_int32"] = bool(pv_want[0] > 2**31)
        out["int64_boundary_closed_form"] = bool(np.array_equal(got.per_vertex, pv_want))
        out["int64_boundary_vs_batched"] = equal(got, batched(star, ops, parts, 4))

        # --- whole-graph redo pass ----------------------------------------
        detour, dops, dst = detour_graph()
        parts = (np.arange(detour.n_nodes) % 4).astype(np.int64)
        rep = ShardedTrafficReplayer(detour, "gis_short", mesh, chunk=2)
        got = rep.replay(dops, parts, 4)
        out["redo_pass_exercised"] = rep.last_redo_ops > 0
        out["redo_pass_bit_equal"] = equal(got, batched(detour, dops, parts, 4, chunk=2))
        save("detour", got)

        # --- resident replay across partition maps ------------------------
        for name, pattern, n_ops in (("filesystem", "filesystem", 403),
                                     ("twitter", "twitter", 401),
                                     ("gis", "gis_short", 157)):
            g = datasets.load(name, scale=0.004)
            ops = generate_ops(g, n_ops=n_ops, seed=1, pattern=pattern)
            parts = partitioners.random_partition(g.n_nodes, 4, seed=0)
            ok = equal(replay_sharded(g, ops, mesh, parts, 4), batched(g, ops, parts, 4))
            for i in range(3):
                parts = apply_dynamism(parts, generate_dynamism(parts, 0.05, "random", k=4, seed=i))
                got = replay_sharded(g, ops, mesh, parts, 4)       # resident fold
                ok &= equal(got, batched(g, ops, parts, 4))
                ok &= equal(got, replay_sharded(g, ops, mesh, parts, 4, resident=False))
            out[f"resident_{pattern}_bit_equal"] = ok
            rep = get_replayer(g, pattern, mesh)
            state = ops.__dict__["_resident_replay"][rep]
            out[f"resident_{pattern}_solved"] = state.solved
            out[f"resident_{pattern}_bytes"] = state.state_bytes()

        # --- read replicas: the mask enters through cross_deg and finalize -
        for name, pattern, n_ops in (("twitter", "twitter", 401), ("gis", "gis_short", 157)):
            g = datasets.load(name, scale=0.004)
            ops = generate_ops(g, n_ops=n_ops, seed=1, pattern=pattern)
            parts = partitioners.random_partition(g.n_nodes, 4, seed=0)
            hot = np.zeros(g.n_nodes, dtype=bool)
            hot[np.argsort(-np.bincount(g.receivers, minlength=g.n_nodes), kind="stable")[:16]] = True
            plain = replay_sharded(g, ops, mesh, parts, 4)
            got = replay_sharded(g, ops, mesh, parts, 4, replicated=hot)   # resident
            out[f"replicated_{pattern}_bit_equal"] = equal(
                got, batched(g, ops, parts, 4, replicated=hot))
            out[f"replicated_{pattern}_moves_traffic"] = not equal(got, plain)

        # --- dirty-set redo on the unchanged graph ------------------------
        g = datasets.load("gis", scale=0.004)
        ops = generate_ops(g, n_ops=157, seed=1, pattern="gis_short")
        parts = partitioners.random_partition(g.n_nodes, 4, seed=3)
        replay_sharded(g, ops, mesh, parts, 4)  # capture
        rep = get_replayer(g, "gis_short", mesh)
        rep.invalidate(ops, ops.starts[:5])
        got = replay_sharded(g, ops, mesh, parts, 4)
        out["dirty_redo_partial"] = 0 < rep.last_redo_ops < ops.n_ops
        out["dirty_redo_bit_equal"] = equal(got, batched(g, ops, parts, 4))

        # --- max_expansions authoritative end to end ----------------------
        parts = (np.arange(detour.n_nodes) % 4).astype(np.int64)
        detour, dops, dst = detour_graph()
        ref_uncapped = batched(detour, dops, parts, 4)
        ref_cap = batched(detour, dops, parts, 4, chunk=2, max_expansions=7)
        got_cap = replay_sharded(detour, dops, mesh, parts, 4, chunk=2, max_expansions=7)
        rep_cap = get_replayer(detour, "gis_short", mesh, chunk=2, max_expansions=7)
        out["max_expansions_engine_value"] = rep_cap.engine.max_expansions == 7
        out["max_expansions_redo_exercised"] = rep_cap.last_redo_ops > 0
        out["max_expansions_bit_equal"] = equal(got_cap, ref_cap)
        out["max_expansions_bites"] = not equal(got_cap, ref_uncapped)
        parts2 = np.roll(parts, 1)
        out["max_expansions_resident_bit_equal"] = equal(
            replay_sharded(detour, dops, mesh, parts2, 4, chunk=2, max_expansions=7),
            batched(detour, dops, parts2, 4, chunk=2, max_expansions=7))

        # --- structural insert invalidation through the mesh service ------
        svc = PartitionedGraphService(detour, 4, mesh=mesh)
        svc.partition_with(parts.astype(np.int32))
        before = svc.run_ops(dops)
        w_short = np.float32(np.hypot(
            detour.node_attrs["lon"][dst] - detour.node_attrs["lon"][0],
            detour.node_attrs["lat"][dst] - detour.node_attrs["lat"][0]))
        svc.apply_dynamism(DynamismLog(
            vertices=np.array([5]), targets=np.array([1], np.int32), method="random", k=4,
            insert_senders=np.array([0]), insert_receivers=np.array([dst]),
            insert_weights=np.array([w_short], np.float32)))
        after = svc.run_ops(dops)                     # resident, partial redo
        cold_new = batched(svc.graph, dops, svc.parts, 4)
        rep_new = get_replayer(svc.graph, "gis_short", mesh)
        out["structural_bit_equal"] = equal(after, cold_new)
        out["structural_route_shortened"] = bool(after.per_op_total[0] < before.per_op_total[0])
        out["structural_redo_partial"] = 0 < rep_new.last_redo_ops < dops.n_ops
        out["structural_next_slice_bit_equal"] = equal(svc.run_ops(dops), cold_new)
        out["structural_resident_bytes"] = svc.logger.resident_state_bytes
        save("structural", after)

        # --- resident states migrated across vertex growth ----------------
        for name, pattern in (("gis", "gis_short"), ("filesystem", "filesystem")):
            g = datasets.load(name, scale=0.004)
            ops = generate_ops(g, n_ops=157, seed=1, pattern=pattern)
            svc = PartitionedGraphService(g, 4, mesh=mesh)
            svc.partition_with(partitioners.random_partition(g.n_nodes, 4, seed=0).astype(np.int32))
            svc.run_ops(ops)
            ok, moved, partial = True, 0, []
            for i in range(2):
                log = InsertPartitioner("random", 4, seed=i).allocate(
                    svc.parts, 0.02, insert_rate=0.5, graph=svc.graph)
                old = svc.graph
                states = list(ops.__dict__["_resident_replay"].values())
                svc.apply_dynamism(log)
                moved += sum(st.graph is svc.graph for st in states)
                got = svc.run_ops(ops)
                rep = get_replayer(svc.graph, pattern, mesh)
                partial.append(rep.last_redo_ops)
                ok &= old.n_nodes < svc.graph.n_nodes
                ok &= equal(got, batched(svc.graph, ops, svc.parts, 4))
            out[f"growth_{pattern}_bit_equal"] = ok
            out[f"growth_{pattern}_migrated"] = moved
            out[f"growth_{pattern}_redo_ops"] = partial
        # a second log never replayed resident has nothing to migrate
        out["migrate_without_state"] = migrate_resident_states(
            generate_ops(g, n_ops=5, seed=9), g, svc.graph, np.arange(3))

        # --- degraded mode ------------------------------------------------
        g = datasets.load("filesystem", scale=0.002, seed=0)
        svc = PartitionedGraphService(g, 4, mesh=mesh)
        svc.partition_with(partitioners.random_partition(g.n_nodes, 4, seed=0))
        ops = generate_ops(g, n_ops=80, seed=0)
        healthy = svc.run_ops(ops)
        svc.mark_shard_failed(0)
        degraded = svc.run_ops(ops)
        b = -(-ops.n_ops // mesh.size)
        out["degraded_bit_equal"] = equal(healthy, degraded)
        out["degraded_replays"] = svc.logger.degraded_replays
        out["degraded_ops"] = svc.logger.degraded_ops
        out["degraded_ops_want"] = min(b, ops.n_ops)
        svc.mark_shard_recovered(0)
        out["recovered_bit_equal"] = equal(healthy, svc.run_ops(ops))
        health = svc.logger.health_report()
        out["health_after_recovery"] = [health["degraded_replays"], health["degraded_ops"]]
        # every shard down: every op is degraded
        for s in range(mesh.size):
            svc.mark_shard_failed(s)
        svc.run_ops(ops)
        out["all_failed_degraded_ops"] = svc.logger.degraded_ops - health["degraded_ops"]
        for s in range(mesh.size):
            svc.mark_shard_recovered(s)
        # the fault plan's schedule degrades exactly its slices
        plan = FaultPlan().fail_shard(1, shard=0, slices=1)
        svc.fault_plan = plan
        seen = []
        for i in range(3):
            plan.begin_slice(i)
            got = svc.run_ops(ops)
            seen.append(svc.logger.degraded_replays)
            out[f"plan_slice{i}_bit_equal"] = equal(got, healthy)
        out["plan_degraded_replays"] = seen
        return out
''')

# Runs ``_SCENARIOS`` on S gloo ranks; rank 0 prints the checks as JSON.
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
            exec(open(os.path.join(out_dir, "scenarios.py")).read(), ns)
            saved = {}

            def save(key, res):
                for f in ns["FIELDS"]:
                    saved[f"{key}/{f}"] = getattr(res, f)

            out = ns["run_cases"](make_replay_mesh(device="cpu"), save)
            if rank == 0:
                np.savez(os.path.join(out_dir, "counters.npz"), **saved)
                print(json.dumps(out), flush=True)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        world, out_dir = int(sys.argv[1]), sys.argv[2]
        mp.spawn(rank_main, args=(world, os.path.join(out_dir, "store"), out_dir), nprocs=world)
''')

# JAX's cold replay_sharded on four forced CPU devices, on the cases the
# port's four ranks save.
_JAX_SHARDED = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    from repro.core import partitioners
    from repro.core.traffic import generate_ops
    from repro.core.traffic_sharded import replay_sharded
    from repro.graphs import datasets
    from repro.launch.mesh import make_replay_mesh

    assert len(jax.devices()) == 4
    mesh = make_replay_mesh(4)
    saved = {}
    for name, pattern, n_ops in (("filesystem", "filesystem", 403), ("twitter", "twitter", 401),
                                 ("gis", "gis_short", 157)):
        g = datasets.load(name, scale=0.004)
        ops = generate_ops(g, n_ops=n_ops, seed=1, pattern=pattern)
        parts = partitioners.random_partition(g.n_nodes, 4, seed=0)
        res = replay_sharded(g, ops, mesh, parts, 4, resident=False)
        for f in ("per_op_total", "per_op_global", "per_partition", "per_vertex"):
            saved[f"{pattern}_{n_ops}/{f}"] = np.asarray(getattr(res, f))
    np.savez(sys.argv[1], **saved)
''')


def _spawn(world: int, tmp: pathlib.Path):
    (tmp / "scenarios.py").write_text(_SCENARIOS)
    (tmp / "spawn.py").write_text(_SPAWN)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(tmp / "spawn.py"), str(world), str(tmp)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return res, dict(np.load(tmp / "counters.npz"))


# ---------------------------------------------------------------------------
# Without a process group (run before the module's group opens)
# ---------------------------------------------------------------------------
def test_replay_sharded_without_a_group_raises():
    from repro_torch.core import partitioners
    from repro_torch.core.traffic import generate_ops
    from repro_torch.core.traffic_sharded import replay_sharded
    from repro_torch.graphs import datasets
    from repro_torch.launch.mesh import make_replay_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_replay_mesh(device="cpu")
    g = datasets.load("filesystem", scale=0.002)
    ops = generate_ops(g, n_ops=20, seed=0)
    parts = partitioners.random_partition(g.n_nodes, 4, seed=0)
    with pytest.raises(ValueError, match="needs a mesh"):
        replay_sharded(g, ops, None, parts, 4)
    # A mesh whose group has closed raises too; nothing falls back.
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    mesh = make_replay_mesh(device="cpu")
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="process group"):
        replay_sharded(g, ops, mesh, parts, 4)


# ---------------------------------------------------------------------------
# One rank, in-process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch.mesh import make_replay_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield make_replay_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_spans_the_group(mesh, monkeypatch):
    from repro_torch.distributed.counters import data_shard_count
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.mesh import make_host_mesh, make_replay_mesh

    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"data": 1})
    assert mesh.comm_device.type == "cpu" and mesh.device.type == "cpu"
    assert data_shard_count(mesh) == 1
    assert make_host_mesh(device="cpu").size == 1
    for bad in (0, 2):
        with pytest.raises(ValueError, match=r"outside 1\.\.1"):
            make_replay_mesh(bad, device="cpu")
    with pytest.raises(ValueError, match="model axis"):
        make_host_mesh(model=2, device="cpu")
    # An NCCL group computes on CUDA (a gloo group never asks).
    monkeypatch.setattr(mesh_mod.dist, "get_backend", lambda: "nccl")
    with pytest.raises(ValueError, match="NCCL"):
        mesh_mod._backend_device(torch.device("cpu"))


class TestCounterPrimitives:
    """Twins of the JAX package's counter tests, on a one-rank mesh."""

    def test_scatter_psum_single_rank(self, mesh):
        from repro_torch.distributed.counters import make_scatter_psum

        fn = make_scatter_psum(mesh, 5)
        ids = torch.tensor([[0, 3, 3, 5, 7]], dtype=torch.int32)  # 5 and 7 dropped
        mass = torch.tensor([[2, 1, 4, 9, 9]], dtype=torch.int32)
        np.testing.assert_array_equal(fn(ids, mass).numpy(), np.array([2, 0, 0, 5, 0]))
        # a shared row broadcast over several mass rows
        fn = make_scatter_psum(mesh, 3)
        got = fn(torch.tensor([0, 2, 9]), torch.tensor([[1, 1, 1], [2, 3, 4]]))
        np.testing.assert_array_equal(got.numpy(), np.array([3, 0, 4]))
        assert got.dtype == torch.int64

    def test_accumulator_widens_before_summing(self):
        from repro_torch.distributed.counters import CounterAccumulator

        acc = CounterAccumulator(2)
        near_max = np.array([2**31 - 7, 1], dtype=np.int32)
        for _ in range(4):
            acc.add(near_max)
        acc.add(torch.tensor([1, 0], dtype=torch.int32))
        assert acc.total[0] == 4 * (2**31 - 7) + 1  # > int32 range: no wrap
        assert acc.total.dtype == np.int64

    def test_counters_match_jax(self, mesh):
        import jax

        from repro.distributed.counters import CounterAccumulator as JaxAcc
        from repro.distributed.counters import make_scatter_psum as jax_psum
        from repro_torch.distributed.counters import CounterAccumulator, make_scatter_psum

        rng = np.random.default_rng(0)
        ids = rng.integers(0, 40, size=(1, 300)).astype(np.int32)
        mass = rng.integers(0, 1000, size=(1, 300)).astype(np.int32)
        want = np.asarray(jax_psum(jax.make_mesh((1,), ("data",)), 32)(ids, mass))
        got = make_scatter_psum(mesh, 32)(torch.as_tensor(ids), torch.as_tensor(mass))
        np.testing.assert_array_equal(got.numpy(), want)
        a, b = CounterAccumulator(32), JaxAcc(32)
        for _ in range(3):
            a.add(want)
            b.add(want)
        np.testing.assert_array_equal(a.total, b.total)


class TestWaveBoundary:
    """The int32 → int64 hand-off at exactly the 2³⁰ margin."""

    def test_wave_splits_at_exact_budget(self):
        from repro_torch.core.traffic_sharded import _WAVE_BUDGET, bfs_wave_ranges

        half = _WAVE_BUDGET // 2
        edges = np.array([half - 1, half - 1], dtype=np.int64)
        assert bfs_wave_ranges(edges) == [(0, 2)]
        edges = np.array([half - 1, half], dtype=np.int64)
        assert bfs_wave_ranges(edges) == [(0, 1), (1, 2)]
        edges = np.array([2 * half + 5], dtype=np.int64)
        assert bfs_wave_ranges(edges) == [(0, 1)]

    def test_waves_equal_jax(self):
        from repro.core.traffic_sharded import bfs_wave_ranges as jax_waves
        from repro_torch.core.traffic_sharded import bfs_wave_ranges

        rng = np.random.default_rng(1)
        edges = rng.integers(0, 1 << 20, size=2000).astype(np.int64)
        for budget in (None, 1 << 22, 1 << 24, 3):
            assert bfs_wave_ranges(edges, budget) == jax_waves(edges, budget)

    def test_accumulator_exact_at_wave_margin(self):
        from repro_torch.core.traffic_sharded import _WAVE_BUDGET
        from repro_torch.distributed.counters import CounterAccumulator

        wave = np.array([_WAVE_BUDGET, 1], dtype=np.int32)
        assert wave[0] == 2**30
        acc = CounterAccumulator(2)
        for _ in range(4):
            acc.add(wave)
        assert acc.total[0] == 4 * 2**30
        assert acc.total[0] > np.iinfo(np.int32).max


def test_replay_cli_joins_an_open_group(mesh, capsys):
    """``launch.replay`` under an open group (as under torchrun) replays,
    verifies against the batched engine and reports the degraded count."""
    from repro_torch.launch import replay

    out = replay.main(["--dataset", "gis", "--scale", "0.002", "--n-ops", "40",
                       "--device", "cpu", "--degraded-check"])
    assert out["verified"] and out["shards"] == 1
    assert out["degraded"]["degraded_replays"] == 1 and out["degraded"]["degraded_ops"] == 40
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["n_ops"] == 40
    assert dist.is_initialized()  # the caller's group stays open


def test_replay_cli_alone_opens_its_own_group():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.replay", "--dataset",
                          "filesystem", "--scale", "0.002", "--n-ops", "50", "--device", "cpu"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["verified"] and res["shards"] == 1 and res["pattern"] == "filesystem"


# ---------------------------------------------------------------------------
# The sharded-replay suite at world sizes 1 to 4
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("sharded4"))


@pytest.fixture(scope="module", params=[1, 2, 3, 4], ids=lambda s: f"S{s}")
def suite(request, mesh, tmp_path_factory):
    world = request.param
    if world == 4:
        return request.getfixturevalue("four_ranks")
    if world == 1:
        ns = {}
        exec(_SCENARIOS, ns)
        saved = {}

        def save(key, res):
            for f in ns["FIELDS"]:
                saved[f"{key}/{f}"] = getattr(res, f)

        return ns["run_cases"](mesh, save), saved
    return _spawn(world, tmp_path_factory.mktemp(f"sharded{world}"))


class TestShardedReplay:
    def test_world_size(self, suite, request):
        assert suite[0]["world"] == request.node.callspec.params["suite"]

    def test_bfs_patterns_bit_equal(self, suite):
        assert suite[0]["filesystem_403"]
        assert suite[0]["twitter_401"]

    def test_gis_patterns_bit_equal(self, suite):
        assert suite[0]["gis_short_157"]
        assert suite[0]["gis_long_45"]

    def test_uneven_and_idle_shards(self, suite):
        assert suite[0]["gis_short_10"]

    def test_delta_stepping_variant(self, suite):
        assert suite[0]["gis_short_64"]

    def test_equals_scalar_oracle(self, suite):
        assert suite[0]["scalar_oracle"]

    def test_int32_wave_int64_host_boundary(self, suite):
        r = suite[0]
        assert r["int64_waves"] > 1
        assert r["int64_boundary_exceeds_int32"]
        assert r["int64_boundary_closed_form"]
        assert r["int64_boundary_vs_batched"]

    def test_replicated_layout_redo_pass(self, suite):
        assert suite[0]["redo_pass_exercised"]
        assert suite[0]["redo_pass_bit_equal"]

    def test_resident_replay_bit_equal_across_slices(self, suite):
        """Resident fold == cold solve == batched engine over 3 maps, each
        pattern family."""
        r = suite[0]
        for pattern in ("filesystem", "twitter", "gis_short"):
            assert r[f"resident_{pattern}_bit_equal"], pattern
            assert r[f"resident_{pattern}_solved"], pattern
            assert r[f"resident_{pattern}_bytes"] > 0, pattern

    def test_read_replicas(self, suite):
        for pattern in ("twitter", "gis_short"):
            assert suite[0][f"replicated_{pattern}_bit_equal"], pattern
            assert suite[0][f"replicated_{pattern}_moves_traffic"], pattern

    def test_uneven_shard_dirty_set_redo(self, suite):
        assert suite[0]["dirty_redo_partial"]
        assert suite[0]["dirty_redo_bit_equal"]

    def test_max_expansions_authoritative(self, suite):
        r = suite[0]
        assert r["max_expansions_engine_value"]
        assert r["max_expansions_redo_exercised"]
        assert r["max_expansions_bit_equal"]
        assert r["max_expansions_bites"]
        assert r["max_expansions_resident_bit_equal"]

    def test_structural_insert_invalidation(self, suite):
        r = suite[0]
        assert r["structural_bit_equal"]
        assert r["structural_route_shortened"]
        assert r["structural_redo_partial"]
        assert r["structural_next_slice_bit_equal"]
        assert r["structural_resident_bytes"] > 0

    def test_migration_across_vertex_growth(self, suite):
        """States move onto each grown graph (GIS re-solves only the
        touched ops; BFS resets and stays resident) and every replay of the
        grown graph equals a batched replay of it."""
        r = suite[0]
        for pattern in ("gis_short", "filesystem"):
            assert r[f"growth_{pattern}_bit_equal"], pattern
            assert r[f"growth_{pattern}_migrated"] == 2, pattern
        assert all(0 < n < 157 for n in r["growth_gis_short_redo_ops"])
        assert r["migrate_without_state"] == 0

    def test_degraded_replay_bit_equal_and_counted(self, suite):
        r = suite[0]
        assert r["degraded_bit_equal"]
        assert r["degraded_replays"] == 1
        assert r["degraded_ops"] == r["degraded_ops_want"]
        assert r["recovered_bit_equal"]
        assert r["health_after_recovery"] == [1, r["degraded_ops_want"]]
        assert r["all_failed_degraded_ops"] == 80

    def test_fault_plan_shard_schedule_degrades_replay(self, suite):
        r = suite[0]
        assert r["plan_degraded_replays"] == [2, 3, 3]
        assert all(r[f"plan_slice{i}_bit_equal"] for i in range(3))


def test_batched_engine_matches_jax_on_the_suite(suite):
    """The port's sharded counters (equal to its batched engine's) equal the
    JAX package's batched engine on the suite's cases."""
    from repro.core import partitioners as jparts
    from repro.core.traffic import execute_ops, generate_ops
    from repro.core.traffic_batched import execute_ops_batched
    from repro.graphs import datasets as jdata

    saved = suite[1]
    for name, pattern, n_ops, kw in (("filesystem", "filesystem", 403, {}),
                                     ("twitter", "twitter", 401, {}),
                                     ("gis", "gis_short", 157, {}),
                                     ("gis", "gis_long", 45, {}),
                                     ("gis", "gis_short", 10, {"chunk": 4}),
                                     ("gis", "gis_short", 64, {"delta_scale": 4.0})):
        g = jdata.load(name, scale=0.004)
        ops = generate_ops(g, n_ops=n_ops, seed=1, pattern=pattern)
        parts = jparts.random_partition(g.n_nodes, 4, seed=0)
        ref = (execute_ops_batched(g, ops, parts, 4, **kw) if kw
               else execute_ops(g, ops, parts, 4, engine="batched"))
        for f in COUNTERS:
            np.testing.assert_array_equal(saved[f"{pattern}_{n_ops}/{f}"], np.asarray(getattr(ref, f)),
                                          err_msg=f"{pattern}_{n_ops}: {f}")


def test_four_ranks_equal_jax_cold_replay_sharded(four_ranks, tmp_path_factory):
    """JAX's cold ``replay_sharded`` on 4 forced CPU devices == the port's
    4-rank replay, on the same logs and maps."""
    tmp = tmp_path_factory.mktemp("jax4")
    (tmp / "jax_sharded.py").write_text(_JAX_SHARDED)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(tmp / "jax_sharded.py"), str(tmp / "jax.npz")],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    want = dict(np.load(tmp / "jax.npz"))
    got = four_ranks[1]
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
