"""The online server on a mesh service, the twin of the JAX package's
``benchmarks/kernel_bench.py serve_smoke`` legs, and ``launch.serve --arch
graph`` on a mesh.

The graph is filesystem plus one parking vertex (the Twitter class's inert
pad), served to ``filesystem`` and ``twitter`` clients under each arrival
process, a clean leg and a crash leg (an admit crash, a commit crash and a
failed-shard window), on a ``PartitionedGraphService`` with a mesh and
``maintenance="shared"``: at one rank in-process and at four gloo ranks
spawned. Each leg, with background DiDiC and without, is held bit for bit
to ``offline_replay`` of its epochs and to the same leg on a meshless
service; the crash leg to the clean leg; and, without maintenance (the
JAX DiDiC map in every service), to the JAX package's meshless
``OnlineServer``. No leg leaves resident replay state: the tick replays
cold, as the JAX tick does.
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

from repro.core import framework as jax_framework
from repro.core import online as jax_online
from repro.core.didic import DidicConfig as JaxDidicConfig
from repro.core.didic import didic_partition as jax_didic_partition
from repro.core.fault import FaultPlan as JaxFaultPlan
from repro.graphs import datasets as jax_datasets

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROCESSES = ("uniform", "bursty", "skewed_hot")
CLASSES = ("filesystem", "twitter")
N_OPS = 48
torch.set_num_threads(1)

# The legs every rank runs (same program, same inputs); ``run_legs``
# returns rank 0's checks and the no-maintenance legs' counters.
_LEGS = textwrap.dedent('''
    import numpy as np

    from repro_torch.core.didic import DidicConfig
    from repro_torch.core.fault import FaultPlan
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.online import BackgroundMaintenance, OnlineServer, make_arrival_stream, offline_replay
    from repro_torch.graphs import datasets

    CLASSES = ("filesystem", "twitter")
    CFG = DidicConfig(k=4, iterations=8, primary_steps=3, secondary_steps=3, smooth_cap=16)


    def graph():
        return datasets.load("filesystem", scale=0.002, seed=1).with_vertices(1)


    def plan(shards):
        return (FaultPlan().crash(3, site="serve:admit").crash(5, site="serve:commit")
                .fail_shard(1, shard=shards - 1, slices=4))


    def serve(g, parts0, arrivals, t_counts, mesh, fault_plan, maintain):
        kw = dict(mesh=mesh, maintenance="shared") if mesh is not None else {}
        svc = PartitionedGraphService(g, 4, didic=CFG, device="cpu", **kw)
        svc.partition_with(parts0.copy())
        svc.fault_plan = fault_plan
        server = OnlineServer(svc, batch_slots=8, queue_limit=32, slo={c: 6 for c in CLASSES},
                              maintenance=BackgroundMaintenance(svc, every=4, budget_iterations=1,
                                                                round_iterations=2) if maintain else None)
        server.submit_stream(arrivals, t_counts)
        return server.run(), svc


    def served_equal(a, b):
        return (all(np.array_equal(a.per_op[c], b.per_op[c]) for c in CLASSES)
                and np.array_equal(a.per_partition, b.per_partition)
                and np.array_equal(a.per_vertex, b.per_vertex))


    def run_legs(mesh, parts0, n_ops, processes):
        g = graph()
        checks, saved = {}, {}
        for process in processes:
            arrivals, t_counts = make_arrival_stream(g, CLASSES, n_ops, seed=0, process=process)
            for maintain in (True, False):
                legs = {}
                for leg in ("clean", "crash"):
                    key = f"{process}/{'maint' if maintain else 'static'}/{leg}"
                    p = plan(mesh.size) if leg == "crash" else None
                    res, svc = serve(g, parts0, arrivals, t_counts, mesh, p, maintain)
                    flat, _ = serve(g, parts0, arrivals, t_counts, None,
                                    plan(mesh.size) if leg == "crash" else None, maintain)
                    off = offline_replay(g, res.epochs, 4, t_counts, device="cpu")
                    legs[leg] = res
                    checks[key] = {
                        "served": res.ops_served, "epochs": len(res.epochs),
                        "offline": (all(np.array_equal(res.per_op[c], off[0][c]) for c in CLASSES)
                                    and np.array_equal(res.per_partition, off[1])
                                    and np.array_equal(res.per_vertex, off[2])),
                        "meshless": (served_equal(res, flat) and res.latency == flat.latency
                                     and res.ticks == flat.ticks
                                     and [e["ops"] for e in res.epochs] == [e["ops"] for e in flat.epochs]),
                        "resident_bytes": svc._resident_state_bytes(),
                        "logged_resident_bytes": res.health["resident_state_bytes"],
                        "recoveries": res.health["recoveries"],
                        "degraded_replays": res.health["degraded_replays"],
                        "degraded_ops": res.health["degraded_ops"],
                    }
                    if not maintain:
                        for c in CLASSES:
                            saved[f"{key}/per_op/{c}"] = res.per_op[c]
                        saved[f"{key}/per_partition"] = res.per_partition
                        saved[f"{key}/per_vertex"] = res.per_vertex
                        checks[key]["latency"] = res.latency
                        checks[key]["ticks"] = res.ticks
                clean, crash = legs["clean"], legs["crash"]
                checks[f"{process}/{'maint' if maintain else 'static'}/crash_equals_clean"] = (
                    served_equal(clean, crash) and clean.latency == crash.latency
                    and clean.ticks == crash.ticks)
        return checks, saved
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
            exec(open(os.path.join(out_dir, "legs.py")).read(), ns)
            parts0 = np.load(os.path.join(out_dir, "parts.npy"))
            checks, saved = ns["run_legs"](make_replay_mesh(device="cpu"), parts0, int(sys.argv[3]),
                                           tuple(sys.argv[4].split(",")))
            if rank == 0:
                np.savez(os.path.join(out_dir, "counters.npz"), **saved)
                print(json.dumps(checks), flush=True)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        world, out_dir = int(sys.argv[1]), sys.argv[2]
        mp.spawn(rank_main, args=(world, os.path.join(out_dir, "store"), out_dir), nprocs=world)
''')


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def test_serve_graph_opens_and_closes_its_own_group(capsys):
    from repro_torch.launch import serve

    assert not dist.is_initialized()  # runs before the module's group opens
    result = serve.serve_graph(16, "bursty", device="cpu")
    assert not dist.is_initialized()
    assert result.ops_served == 16 and result.health["resident_state_bytes"] == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] graph/bursty: 16 ops in ") and " on 1 shard(s), " in out[0]


@pytest.fixture(scope="module")
def jax_parts():
    g = jax_datasets.load("filesystem", scale=0.002, seed=1).with_vertices(1)
    parts, _ = jax_didic_partition(g, JaxDidicConfig(k=4, iterations=8, primary_steps=3,
                                                     secondary_steps=3, smooth_cap=16), seed=0)
    return np.asarray(parts, dtype=np.int32)


@pytest.fixture(scope="module")
def jax_legs(jax_parts):
    """The JAX package's meshless server on the no-maintenance legs."""
    g = jax_datasets.load("filesystem", scale=0.002, seed=1).with_vertices(1)
    out = {}
    for process in PROCESSES:
        arrivals, t_counts = jax_online.make_arrival_stream(g, CLASSES, N_OPS, seed=0, process=process)
        for leg in ("clean", "crash"):
            svc = jax_framework.PartitionedGraphService(g, 4, didic=JaxDidicConfig(k=4))
            svc.partition_with(jax_parts.copy())
            if leg == "crash":
                svc.fault_plan = (JaxFaultPlan().crash(3, site="serve:admit").crash(5, site="serve:commit")
                                  .fail_shard(1, shard=0, slices=4))
            server = jax_online.OnlineServer(svc, batch_slots=8, queue_limit=32,
                                             slo={c: 6 for c in CLASSES})
            server.submit_stream(arrivals, t_counts)
            out[f"{process}/static/{leg}"] = server.run()
    return out


def _legs_ns():
    ns = {}
    exec(_LEGS, ns)
    return ns


@pytest.fixture(scope="module")
def one_rank(jax_parts):
    from repro_torch.launch.mesh import make_replay_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        checks, saved = _legs_ns()["run_legs"](make_replay_mesh(device="cpu"), jax_parts, N_OPS, PROCESSES)
        yield checks, saved
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(jax_parts, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("online4")
    (tmp / "legs.py").write_text(_LEGS)
    (tmp / "spawn.py").write_text(_SPAWN)
    np.save(tmp / "parts.npy", jax_parts)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(tmp / "spawn.py"), "4", str(tmp), str(N_OPS),
                          ",".join(PROCESSES)], capture_output=True, text=True, timeout=300, env=env,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), dict(np.load(tmp / "counters.npz"))


@pytest.fixture(params=["S1", "S4"])
def suite(request):
    return request.getfixturevalue({"S1": "one_rank", "S4": "four_ranks"}[request.param])


@pytest.mark.parametrize("process", PROCESSES)
def test_each_leg_equals_offline_replay_and_the_meshless_server(suite, process):
    checks, _ = suite
    for maint in ("maint", "static"):
        for leg in ("clean", "crash"):
            c = checks[f"{process}/{maint}/{leg}"]
            assert c["served"] == N_OPS and c["offline"] and c["meshless"], (maint, leg, c)
    assert checks[f"{process}/maint/clean"]["epochs"] >= 2  # a background round migrated


@pytest.mark.parametrize("process", PROCESSES)
def test_crash_leg_equals_clean_leg_with_degraded_replays_counted(suite, process):
    checks, _ = suite
    for maint in ("maint", "static"):
        assert checks[f"{process}/{maint}/crash_equals_clean"]
        crash, clean = checks[f"{process}/{maint}/crash"], checks[f"{process}/{maint}/clean"]
        assert crash["recoveries"] == 2 and clean["recoveries"] == 0
        assert crash["degraded_replays"] > 0 and crash["degraded_ops"] > 0
        assert clean["degraded_replays"] == 0


@pytest.mark.parametrize("process", PROCESSES)
def test_no_resident_state_remains(suite, process):
    checks, _ = suite
    for key, c in checks.items():
        if key.startswith(process) and isinstance(c, dict):
            assert c["resident_bytes"] == 0 and c["logged_resident_bytes"] == 0, key


@pytest.mark.parametrize("process", PROCESSES)
def test_static_legs_equal_the_jax_meshless_server(suite, jax_legs, process):
    checks, saved = suite
    for leg in ("clean", "crash"):
        key = f"{process}/static/{leg}"
        want = jax_legs[key]
        for c in CLASSES:
            np.testing.assert_array_equal(saved[f"{key}/per_op/{c}"], np.asarray(want.per_op[c]))
        np.testing.assert_array_equal(saved[f"{key}/per_partition"], np.asarray(want.per_partition))
        np.testing.assert_array_equal(saved[f"{key}/per_vertex"], np.asarray(want.per_vertex))
        got_latency = json.loads(json.dumps(checks[key]["latency"]))
        assert got_latency == json.loads(json.dumps(want.latency)) and checks[key]["ticks"] == want.ticks
