"""The port's placement, halo exchange, mesh DiDiC, device-scan dynamism and
mesh runtime, against the JAX package.

* ``distributed/placement.py`` and ``build_halo_program`` are numpy copies:
  their arrays equal the JAX package's.
* ``make_partitioned_spmm`` (``all_gather`` of boundary rows, then
  ``index_add_``) equals the dense product within 1e-5.
* The mesh DiDiC at 4 gloo ranks meets the JAX package's bars
  (``tests/test_distributed.py``): cut below 0.25 and below
  ``max(2.5·cut_host, 0.1)`` for the port's and the JAX package's
  single-device DiDiC, every part non-empty, 25 % damage repaired below
  half, a second refine on the carried state no worse, pins restored.
* The device scan's logs equal the host loops' and the JAX device scan's
  (the cases of ``tests/test_dynamic_runtime.py``).
* The mesh runtime with ``maintenance="shared"`` equals the meshless
  runtime on every counter of every slice of a schedule with growth, at one
  rank (in-process) and four (spawned); ``"sharded"`` keeps maintenance
  below the unmaintained map; a fault plan's shard failures and a crash
  on a mesh runtime stay bit-exact, with the degraded ops counted.
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
import torch.distributed as dist

from repro_torch.core import partitioners
from repro_torch.core.dynamism import generate_dynamism
from repro_torch.graphs import datasets, generators

ROOT = pathlib.Path(__file__).resolve().parents[1]

_SCENARIOS = textwrap.dedent('''
    import numpy as np

    from repro_torch.core import metrics, partitioners
    from repro_torch.core.didic import DidicConfig, didic_partition
    from repro_torch.core.didic_distributed import (
        didic_partition_distributed, didic_refine_distributed,
    )
    from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
    from repro_torch.core.fault import FaultPlan, RetryPolicy
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.recovery import run_with_recovery
    from repro_torch.core.traffic import generate_ops
    from repro_torch.distributed.halo import build_halo_program, make_partitioned_spmm
    from repro_torch.distributed.placement import build_layout
    from repro_torch.graphs import datasets, generators

    FIELDS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")


    def equal(a, b):
        return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


    def halo_spmm(mesh):
        import torch
        g = generators.two_cluster(n_per=60, p_in=0.2, p_out=0.05, seed=0)
        parts = partitioners.random_partition(g.n_nodes, 4, seed=1)
        layout = build_layout(g, parts, mesh.size)
        spmm = make_partitioned_spmm(build_halo_program(g, layout), mesh)
        x = np.random.default_rng(0).normal(size=(g.n_nodes, 5)).astype(np.float32)
        xp = layout.scatter_features(x)
        rows = slice(mesh.rank * layout.block, (mesh.rank + 1) * layout.block)
        y = spmm(torch.as_tensor(xp[rows]))
        y = torch.cat(mesh.all_gather(y)).numpy()
        s, r, w = g.undirected
        ref = np.zeros_like(x)
        np.add.at(ref, r, w[:, None] * x[s])
        return float(np.abs(layout.gather_features(y) - ref).max())


    def mesh_didic(mesh):
        g = datasets.load("gis", scale=0.003)
        cfg = DidicConfig(k=4, iterations=40)
        parts_d, layout = didic_partition_distributed(g, cfg, mesh, seed=0)
        rng = np.random.default_rng(0)
        damaged = parts_d.copy()
        idx = rng.choice(g.n_nodes, size=g.n_nodes // 4, replace=False)
        damaged[idx] = rng.integers(0, 4, size=idx.shape[0])
        repaired, state = didic_refine_distributed(g, damaged, cfg, mesh, iterations=1)
        repaired2, _ = didic_refine_distributed(g, repaired, cfg, mesh, state=state, iterations=1)
        pinned = np.arange(0, g.n_nodes, 97)
        pinned_out, _ = didic_refine_distributed(g, damaged, cfg, mesh, iterations=1, pinned=pinned)
        # The service's runtime partitioner on a mesh runs both passes there.
        small = generators.two_cluster(n_per=60, p_in=0.2, p_out=0.05, seed=0)
        small_cfg = DidicConfig(k=4, iterations=5)
        svc = PartitionedGraphService(small, 4, didic=small_cfg, mesh=mesh)
        svc.partition_didic(seed=3)
        want, _ = didic_partition_distributed(small, small_cfg, mesh, seed=3)
        initial_equal = bool(np.array_equal(svc.parts, want))
        initial_state = svc.runtime.state is None
        svc.maintain()
        return {
            "service_initial_equal": initial_equal,
            "service_initial_state_none": initial_state,
            "service_state_rows": int(svc.runtime.state.w.shape[0]),
            "service_engine": svc.engine,
            "cut_distributed": metrics.edge_cut_fraction(g, parts_d),
            "sizes": np.bincount(parts_d, minlength=4).tolist(),
            "cut_damaged": metrics.edge_cut_fraction(g, damaged),
            "cut_repaired": metrics.edge_cut_fraction(g, repaired),
            "cut_repaired2": metrics.edge_cut_fraction(g, repaired2),
            "pins_restored": bool(np.array_equal(pinned_out[pinned], damaged[pinned])),
            "state_rows": int(state.w.shape[0]),
            "block": int(layout.block),
        }


    def runtime_parity(mesh, name, n_ops, n_slices, maintain_every, insert_rate):
        """Meshless runtime against the mesh runtime (shared maintenance):
        every slice's counters, records, final map."""
        g = datasets.load(name, scale=0.004)
        ops = generate_ops(g, n_ops=n_ops, seed=0)
        cfg = DidicConfig(k=4, iterations=10, smooth_cap=64)
        parts0, _ = didic_partition(g, cfg, seed=0, device="cpu")

        def build(m):
            svc = PartitionedGraphService(g, 4, didic=cfg, device="cpu", mesh=m,
                                          maintenance="shared")
            svc.partition_with(parts0.copy())
            return DynamicExperimentRuntime(svc, insert_method="least_traffic", seed=0)

        got = {"host": [], "mesh": []}
        kw = dict(n_slices=n_slices, amount=0.05, maintain_every=maintain_every,
                  insert_rate=insert_rate)
        host_rt = build(None)
        host = host_rt.run(ops, on_slice=lambda i, r: got["host"].append(r), **kw)
        mesh_rt = build(mesh)
        dev = mesh_rt.run(ops, on_slice=lambda i, r: got["mesh"].append(r), **kw)
        return {
            "engines": [host_rt.service.engine, mesh_rt.service.engine,
                        mesh_rt.insert.engine],
            "slices": len(got["mesh"]),
            "all_counters_equal": all(equal(a, b) for a, b in zip(got["host"], got["mesh"])),
            "records_equal": host.records == dev.records,
            "parts_equal": bool(np.array_equal(host.parts, dev.parts)),
            "grown": int(mesh_rt.service.graph.n_nodes - g.n_nodes),
            "maintained": sum(r.maintained for r in dev.records),
            "resident_bytes": mesh_rt.service.logger.resident_state_bytes,
        }


    def sharded_maintenance(mesh):
        g = datasets.load("filesystem", scale=0.004)
        ops = generate_ops(g, n_ops=500, seed=0)
        cfg = DidicConfig(k=4, iterations=10, smooth_cap=64)
        parts0, _ = didic_partition(g, cfg, seed=0, device="cpu")

        def build(maintenance):
            svc = PartitionedGraphService(g, 4, didic=cfg, mesh=mesh, maintenance=maintenance)
            svc.partition_with(parts0.copy())
            return DynamicExperimentRuntime(svc, insert_method="least_traffic", seed=0)

        unmaintained = build("shared").run(ops, n_slices=6, amount=0.05, maintain_every=10**9)
        maintained = build("sharded").run(ops, n_slices=6, amount=0.05, maintain_every=2)
        return {
            "sharded_percent_global": maintained.final.percent_global,
            "unmaintained_percent_global": unmaintained.final.percent_global,
        }


    def fault_runs(mesh):
        """A shard down for slices 1-2 and a crash at slice 3 on a mesh
        runtime, against the same runtime with no fault and with the shard
        failure alone."""
        g = datasets.load("gis", scale=0.004)
        ops = generate_ops(g, n_ops=120, seed=3)
        cfg = DidicConfig(k=4, iterations=6)
        parts0, _ = didic_partition(g, cfg, seed=0, device="cpu")

        def run(plan):
            got, runtimes = {}, []

            def make():
                svc = PartitionedGraphService(g, 4, didic=cfg, mesh=mesh, maintenance="shared")
                svc.partition_with(parts0.copy())
                runtimes.append(DynamicExperimentRuntime(svc, insert_method="least_traffic",
                                                         seed=7))
                return runtimes[-1]

            out, stats = run_with_recovery(
                make, g, ops, 5, 0.05, maintain_every=2, insert_rate=0.3, fault_plan=plan,
                retry_policy=RetryPolicy(sleep=lambda s: None), snapshot_every=2,
                on_slice=lambda i, r: got.__setitem__(i, r))
            health = runtimes[-1].service.logger.health_report()
            return got, out, stats.recoveries, [health["degraded_replays"], health["degraded_ops"]]

        base, base_out, _, base_health = run(None)
        shard, shard_out, shard_rec, shard_health = run(FaultPlan().fail_shard(1, shard=0, slices=2))
        both, both_out, both_rec, both_health = run(
            FaultPlan().fail_shard(1, shard=0, slices=2).crash(3, "apply:pre_commit"))
        return {
            "shard_bit_exact": all(equal(base[i], shard[i]) for i in range(5)),
            "crash_bit_exact": all(equal(base[i], both[i]) for i in range(5)),
            "records_equal": base_out.records == shard_out.records == both_out.records,
            "parts_equal": bool(np.array_equal(base_out.parts, both_out.parts)),
            "recoveries": [shard_rec, both_rec],
            "health": [base_health, shard_health, both_health],
            "shard0_ops": min(-(-ops.n_ops // mesh.size), ops.n_ops),
        }


    def run_cases(mesh):
        out = {"world": mesh.size, "halo_max_err": halo_spmm(mesh)}
        out["didic"] = mesh_didic(mesh)
        # The JAX parity schedule (20 × 5 %, maintenance every 4th slice),
        # with 20 % inserts; and a GIS schedule whose growth re-solves ops.
        out["parity_filesystem"] = runtime_parity(mesh, "filesystem", 1000, 20, 4, 0.2)
        out["parity_gis"] = runtime_parity(mesh, "gis", 150, 5, 3, 0.3)
        out["sharded"] = sharded_maintenance(mesh)
        out["faults"] = fault_runs(mesh)
        return out
''')

_SPAWN = textwrap.dedent('''
    import json, os, sys
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, world, store_path, scenarios):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        try:
            from repro_torch.launch.mesh import make_replay_mesh
            ns = {}
            exec(open(scenarios).read(), ns)
            out = ns["run_cases"](make_replay_mesh(device="cpu"))
            if rank == 0:
                print(json.dumps(out), flush=True)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        world, tmp = int(sys.argv[1]), sys.argv[2]
        mp.spawn(rank_main, args=(world, os.path.join(tmp, "store"),
                                  os.path.join(tmp, "scenarios.py")), nprocs=world)
''')


@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch.mesh import make_replay_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield make_replay_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[1, 4], ids=lambda s: f"S{s}")
def runs(request, mesh, tmp_path_factory):
    if request.param == 1:
        ns = {}
        exec(_SCENARIOS, ns)
        return ns["run_cases"](mesh)
    tmp = tmp_path_factory.mktemp("distributed4")
    (tmp / "scenarios.py").write_text(_SCENARIOS)
    (tmp / "spawn.py").write_text(_SPAWN)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(tmp / "spawn.py"), "4", str(tmp)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def host_cuts():
    """The port's and the JAX package's single-device DiDiC on the mesh
    DiDiC's graph and config."""
    from repro.core.didic import DidicConfig as JaxConfig
    from repro.core.didic import didic_partition as jax_didic
    from repro.graphs import datasets as jdata
    from repro_torch.core import metrics
    from repro_torch.core.didic import DidicConfig, didic_partition

    g = datasets.load("gis", scale=0.003)
    parts, _ = didic_partition(g, DidicConfig(k=4, iterations=40), seed=0, device="cpu")
    jparts, _ = jax_didic(jdata.load("gis", scale=0.003), JaxConfig(k=4, iterations=40), seed=0)
    return {"port": metrics.edge_cut_fraction(g, parts),
            "jax": metrics.edge_cut_fraction(g, np.asarray(jparts))}


# ---------------------------------------------------------------------------
# Placement and halo tables: numpy copies of the JAX package's
# ---------------------------------------------------------------------------
class TestPlacement:
    @pytest.mark.parametrize("k,shards", [(4, 4), (8, 4), (4, 2), (3, 3), (4, 1)])
    def test_layout_and_halo_equal_jax(self, k, shards):
        from repro.distributed.halo import build_halo_program as jax_halo
        from repro.distributed.placement import build_layout as jax_layout
        from repro.graphs import generators as jgen
        from repro_torch.distributed.halo import build_halo_program
        from repro_torch.distributed.placement import build_layout

        g = generators.two_cluster(n_per=60, p_in=0.2, p_out=0.05, seed=0)
        jg = jgen.two_cluster(n_per=60, p_in=0.2, p_out=0.05, seed=0)
        parts = partitioners.random_partition(g.n_nodes, k, seed=1)
        lay, jlay = build_layout(g, parts, shards), jax_layout(jg, parts, shards)
        for f in ("old_to_new", "new_to_old", "shard_of_node"):
            np.testing.assert_array_equal(getattr(lay, f), getattr(jlay, f), err_msg=f)
        assert (lay.n_shards, lay.block, lay.padded_n) == (jlay.n_shards, jlay.block, jlay.padded_n)
        w = np.random.default_rng(2).random(g.undirected[0].shape[0]).astype(np.float32)
        for ew in (None, w):
            prog, jprog = build_halo_program(g, lay, ew), jax_halo(jg, jlay, ew)
            for f in ("edge_src", "edge_dst", "edge_w", "edge_mask", "boundary_idx", "ghost_src"):
                np.testing.assert_array_equal(getattr(prog, f), getattr(jprog, f), err_msg=f)
            assert prog.halo_bytes(128) == jprog.halo_bytes(128)

    def test_layout_roundtrip_and_ownership(self):
        from repro_torch.distributed.placement import build_layout

        g = generators.two_cluster(n_per=50, seed=0)
        parts = partitioners.random_partition(g.n_nodes, 8, seed=0)
        layout = build_layout(g, parts, 4)  # k=8 folds onto 4 shards
        x = np.random.default_rng(0).normal(size=(g.n_nodes, 3)).astype(np.float32)
        np.testing.assert_array_equal(layout.gather_features(layout.scatter_features(x)), x)
        np.testing.assert_array_equal(layout.shard_of_node, parts % 4)
        np.testing.assert_array_equal(layout.old_to_new // layout.block, layout.shard_of_node)

    def test_k_smaller_than_shards_rejected(self):
        from repro_torch.distributed.placement import build_layout

        g = generators.two_cluster(n_per=20, seed=0)
        with pytest.raises(ValueError, match="k=2"):
            build_layout(g, partitioners.random_partition(g.n_nodes, 2, seed=0), 4)

    def test_collective_bytes_equal_jax(self):
        from repro.distributed.placement import collective_bytes_estimate as jax_bytes
        from repro.graphs import datasets as jdata
        from repro_torch.distributed.placement import collective_bytes_estimate

        g, jg = datasets.load("gis", scale=0.005), jdata.load("gis", scale=0.005)
        for seed in (0, 1):
            parts = partitioners.random_partition(g.n_nodes, 4, seed=seed)
            assert collective_bytes_estimate(g, parts, 128) == jax_bytes(jg, parts, 128)
        lin = partitioners.linear_partition(g.n_nodes, 4)
        b_lin, _ = collective_bytes_estimate(g, lin, 128)
        b_rand, _ = collective_bytes_estimate(g, partitioners.random_partition(g.n_nodes, 4, seed=0), 128)
        assert b_lin < b_rand


# ---------------------------------------------------------------------------
# Device-scan dynamism == host loops == the JAX device scan
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fs():
    return datasets.load("filesystem", scale=0.005)


def _logs_equal(parts, amount, method, k, vt=None, seed=0, insert_rate=0.0, graph=None,
                jgraph=None):
    from repro.core.dynamism import generate_dynamism as jax_generate

    kw = dict(k=k, vertex_traffic=vt, seed=seed, insert_rate=insert_rate)
    host = generate_dynamism(parts, amount, method, graph=graph, engine="host", **kw)
    dev = generate_dynamism(parts, amount, method, graph=graph, engine="device", device="cpu", **kw)
    jdev = jax_generate(parts, amount, method, graph=jgraph, engine="device", **kw)
    for log in (dev, jdev):
        np.testing.assert_array_equal(host.vertices, log.vertices)
        np.testing.assert_array_equal(host.targets, log.targets)
        if insert_rate:
            np.testing.assert_array_equal(host.unit_is_insert, log.unit_is_insert)
            np.testing.assert_array_equal(host.insert_senders, log.insert_senders)
            np.testing.assert_array_equal(host.insert_unit, log.insert_unit)
    return host, dev


class TestDeviceScanDynamism:
    def test_unroll_blocks_equal_jax(self):
        from repro.core.dynamic_runtime import _unroll_blocks as jax_blocks
        from repro_torch.core.dynamic_runtime import _unroll_blocks

        rng = np.random.default_rng(3)
        parts = rng.integers(0, 3, size=9).astype(np.int32)
        for units, pad in ((1, 0), (11, 0), (24, 0), (13, 40)):
            movers = rng.integers(0, 9, size=units)
            ins = rng.random(units) < 0.4
            for insert in (None, ins):
                np.testing.assert_array_equal(
                    _unroll_blocks(movers, parts, insert=insert, pad_units=pad),
                    jax_blocks(movers, parts, insert=insert, pad_units=pad))

    def test_random_identical(self, fs):
        parts = partitioners.random_partition(fs.n_nodes, 4, seed=0)
        _logs_equal(parts, 0.1, "random", 4, seed=3)

    @pytest.mark.parametrize("k", [2, 4, 7])
    def test_fewest_vertices_identical(self, fs, k):
        parts = partitioners.random_partition(fs.n_nodes, k, seed=1)
        for amount, seed in ((0.02, 0), (0.25, 5)):
            _logs_equal(parts, amount, "fewest_vertices", k, seed=seed)

    def test_fewest_vertices_all_ties(self, fs):
        n = (fs.n_nodes // 4) * 4
        parts = (np.arange(n) % 4).astype(np.int32)
        _logs_equal(parts, 0.1, "fewest_vertices", 4, seed=2)

    @pytest.mark.parametrize("method", ["fewest_vertices", "least_traffic"])
    def test_unrolled_tail_and_duplicate_movers(self, method):
        rng = np.random.default_rng(3)
        parts = rng.integers(0, 3, size=8).astype(np.int32)
        vt = rng.integers(0, 100, size=8) if method == "least_traffic" else None
        for amount in (0.125, 0.375, 1.375, 3.0):
            for seed in range(3):
                _logs_equal(parts, amount, method, 3, vt=vt, seed=seed)

    def test_zero_units(self, fs):
        parts = partitioners.random_partition(fs.n_nodes, 4, seed=0)
        log = generate_dynamism(parts, 0.0, "fewest_vertices", k=4, engine="device", device="cpu")
        assert log.units == 0

    @pytest.mark.parametrize("k", [2, 4])
    def test_least_traffic_measured_counts(self, fs, k):
        from repro_torch.core.traffic import execute_ops, generate_ops

        ops = generate_ops(fs, n_ops=300, seed=0)
        parts = partitioners.random_partition(fs.n_nodes, k, seed=0)
        vt = execute_ops(fs, ops, parts, k, device="cpu").per_vertex
        for amount in (0.05, 0.25):
            _logs_equal(parts, amount, "least_traffic", k, vt=vt)

    def test_least_traffic_beyond_int32(self):
        rng = np.random.default_rng(7)
        n, k = 400, 4
        parts = rng.integers(0, k, size=n).astype(np.int32)
        vt = rng.integers(0, 1 << 40, size=n)
        vt[::3] = 0  # ties in the running totals
        _logs_equal(parts, 0.3, "least_traffic", k, vt=vt, seed=9)

    @pytest.mark.parametrize("method", ["fewest_vertices", "least_traffic"])
    def test_insert_bearing_logs_identical(self, fs, method):
        from repro.graphs import datasets as jdata
        from repro_torch.core.traffic import execute_ops, generate_ops

        g, jg = datasets.load("filesystem", scale=0.005), jdata.load("filesystem", scale=0.005)
        parts = partitioners.random_partition(g.n_nodes, 4, seed=0)
        vt = (execute_ops(g, generate_ops(g, n_ops=300, seed=0), parts, 4, device="cpu").per_vertex
              if method == "least_traffic" else None)
        for rate in (0.2, 0.6, 1.0):
            for seed in range(2):
                host, dev = _logs_equal(parts, 0.05, method, 4, vt=vt, seed=seed,
                                        insert_rate=rate, graph=g, jgraph=jg)
                assert host.n_new_vertices == dev.n_new_vertices > 0

    @pytest.mark.parametrize("method", ["fewest_vertices", "least_traffic"])
    def test_insert_heavy_duplicate_anchors(self, method):
        from repro.graphs import generators as jgen

        rng = np.random.default_rng(5)
        parts = rng.integers(0, 3, size=6).astype(np.int32)
        vt = rng.integers(0, 50, size=6) if method == "least_traffic" else None
        g, jg = (generators.random_graph(6, avg_degree=2.0, seed=0),
                 jgen.random_graph(6, avg_degree=2.0, seed=0))
        for amount in (0.5, 2.0, 4.0):
            for seed in range(3):
                _logs_equal(parts, amount, method, 3, vt=vt, seed=seed, insert_rate=0.5, graph=g,
                            jgraph=jg)

    def test_least_traffic_rejects_fractional_and_missing(self, fs):
        parts = partitioners.random_partition(fs.n_nodes, 4, seed=0)
        with pytest.raises(ValueError, match="integer-valued"):
            generate_dynamism(parts, 0.01, "least_traffic", k=4,
                              vertex_traffic=np.full(fs.n_nodes, 0.5), engine="device", device="cpu")
        with pytest.raises(ValueError, match="exact integer range"):
            generate_dynamism(parts, 0.01, "least_traffic", k=4,
                              vertex_traffic=np.full(fs.n_nodes, 1 << 50), engine="device",
                              device="cpu")
        with pytest.raises(ValueError, match="requires vertex_traffic"):
            generate_dynamism(parts, 0.01, "least_traffic", k=4, engine="device", device="cpu")

    def test_host_and_device_partitioners_agree(self, fs):
        from repro_torch.core.framework import InsertPartitioner

        parts = partitioners.random_partition(fs.n_nodes, 4, seed=0)
        h = InsertPartitioner("fewest_vertices", k=4, seed=3, engine="host")
        d = InsertPartitioner("fewest_vertices", k=4, seed=3, engine="device", device="cpu")
        for _ in range(2):
            lh, ld = h.allocate(parts, 0.03), d.allocate(parts, 0.03)
            np.testing.assert_array_equal(lh.vertices, ld.vertices)
            np.testing.assert_array_equal(lh.targets, ld.targets)


# ---------------------------------------------------------------------------
# The mesh runs, at one rank (in-process) and four (spawned)
# ---------------------------------------------------------------------------
class TestMeshRuns:
    def test_world_size(self, runs, request):
        assert runs["world"] == request.node.callspec.params["runs"]

    def test_partitioned_spmm_equals_dense(self, runs):
        assert runs["halo_max_err"] < 1e-5

    def test_distributed_didic_matches_host_quality(self, runs, host_cuts):
        """The thesis's Future Work (§8.2): DiDiC on a mesh reaches the
        single-device quality (the JAX package's bars)."""
        d = runs["didic"]
        assert d["cut_distributed"] < 0.25
        for ref in ("port", "jax"):
            assert d["cut_distributed"] < max(2.5 * host_cuts[ref], 0.1), ref
        assert min(d["sizes"]) > 0

    def test_sharded_maintenance_repairs_damage(self, runs):
        d = runs["didic"]
        assert d["cut_damaged"] > 2 * d["cut_distributed"]
        assert d["cut_repaired"] < 0.5 * d["cut_damaged"]
        assert d["cut_repaired2"] < d["cut_damaged"]
        assert d["cut_repaired2"] <= d["cut_repaired"] * 1.05
        assert d["pins_restored"]
        assert d["state_rows"] == d["block"]  # the carried state is this rank's block

    def test_runtime_partitioner_on_a_mesh(self, runs):
        d = runs["didic"]
        assert d["service_engine"] == "device"
        assert d["service_initial_equal"] and d["service_initial_state_none"]
        assert d["service_state_rows"] > 0

    @pytest.mark.parametrize("case", ["filesystem", "gis"])
    def test_shared_maintenance_equals_meshless_every_slice(self, runs, case):
        r = runs[f"parity_{case}"]
        assert r["engines"] == ["host", "device", "device"]
        assert r["slices"] == (20 if case == "filesystem" else 5)
        assert r["all_counters_equal"]
        assert r["records_equal"]
        assert r["parts_equal"]
        assert r["grown"] > 0
        assert r["maintained"] >= 1
        assert r["resident_bytes"] > 0

    def test_sharded_maintenance_holds_quality(self, runs):
        r = runs["sharded"]
        assert r["sharded_percent_global"] < r["unmaintained_percent_global"], r

    def test_fault_plan_shard_failures_on_a_mesh_runtime(self, runs):
        f = runs["faults"]
        assert f["shard_bit_exact"]
        assert f["crash_bit_exact"]
        assert f["records_equal"]
        assert f["parts_equal"]
        assert f["recoveries"] == [0, 1]
        base, shard, both = f["health"]
        assert base == [0, 0]
        assert shard == both == [2, 2 * f["shard0_ops"]]
