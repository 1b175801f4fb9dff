"""The paper's Stress, Dynamic and Insert-growth tables on a mesh: the
port's ``PaperBench(...).stress_experiment(mesh=...)`` and its siblings
over a ``torch.distributed`` group, against the port's meshless rows and
the JAX bench (``benchmarks/paper_tables.py``, loaded by file path) on the
CPU, at the sizes of ``tests/test_torch_paper_tables.py``.

The ranks: one gloo rank in-process (a ``HashStore`` group, a module
fixture), and 2 and 4 gloo ranks started by ``torch.multiprocessing.spawn``
over a ``FileStore`` in a subprocess; every rank runs the same tables
(``_SCENARIO``) and rank 0 prints them as JSON.

What is held:
- ``maintenance="shared"`` (sharded replay and device-scan dynamism on the
  mesh, the single-device DiDiC) at 1, 2 and 4 ranks: the Stress and
  Dynamic rows equal the port's meshless rows ``csv()`` for ``csv()``, and,
  with the JAX run's DiDiC partitions, states and maintained maps injected
  (as ``tests/test_torch_paper_tables.py`` injects them), the JAX bench's
  meshless rows. ``cycle_s`` is a wall clock: only its name and its
  derived string, which says ``(resident device replay)`` on a mesh.
- the mesh DiDiC (``maintenance="auto"``) at 2 ranks, from the JAX
  run's initial partitions: Stress, Dynamic and Insert-growth row names
  and derived strings as JAX's, every T_G % row within
  ``|port − ref| ≤ 0.25·ref + 0.01`` (as fractions) of the JAX bench's
  meshless row, and the grown vertex counts equal. The JAX bench's own
  mesh tables raise on JAX 0.9.0 in this mode (ROADMAP.md, "Notes on the
  reference"), so its meshless rows are the reference.
"""

import importlib.util
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

from repro.configs.paper_didic import PaperExperimentConfig as JaxConfig
from repro_torch import paper_tables
from repro_torch.configs.paper_didic import PaperExperimentConfig

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE = dict(scale=0.002, didic_iterations=10, n_ops=200, n_ops_gis=40)
SHARED = ("stress", "dynamic")
AUTO = ("stress", "dynamic", "insert-growth")
MESH_DERIVED = " (resident device replay)"

# The tables every rank runs. ``jax_maps`` is the npz the JAX run left:
# its DiDiC partitions and states, and each run's maintained maps.
_SCENARIO = textwrap.dedent('''
    import numpy as np

    from repro_torch import convert, paper_tables
    from repro_torch.configs.paper_didic import PaperExperimentConfig

    SIZE = dict(scale=0.002, didic_iterations=10, n_ops=200, n_ops_gis=40)
    DATASETS = ("filesystem", "gis", "twitter")


    def csvs(rows):
        return [r.csv() for r in rows]


    def injected_bench(jax_maps, tables):
        """A bench on the JAX run's partitions and states; with ``tables``,
        each run of those tables also gets the JAX run's maintained maps."""
        z = np.load(jax_maps)
        bench = paper_tables.PaperBench(PaperExperimentConfig(**SIZE), device="cpu")
        for name in DATASETS:
            bench._parts[(name, "didic", 4)] = z[f"parts/{name}"].astype(np.int32)
            bench._parts[(name, "didic_state", 4)] = convert.didic_state_from_arrays(
                *(z[f"state/{name}/{f}"] for f in ("w", "l", "parts", "beta")), device="cpu")
        if tables:
            supply = iter([[z[f"maps/{t}/{i}/{j}"] for j in range(int(z[f"maps/{t}/{i}"]))]
                           for t in tables for i in range(int(z[f"maps/{t}"]))])
            make = bench._runtime_for

            def injected(*args, **kwargs):
                runtime = make(*args, **kwargs)
                run_maps = iter(next(supply))
                runtime.service.runtime.maintain = lambda *a, **kw: next(run_maps).copy()
                return runtime

            bench._runtime_for = injected
        return bench


    def run_tables(mesh, jax_maps, auto):
        out = {"world": mesh.size}
        bench = paper_tables.PaperBench(PaperExperimentConfig(**SIZE), device="cpu")
        out["shared/stress"] = csvs(bench.stress_experiment(mesh=mesh, maintenance="shared"))
        out["shared/dynamic"] = csvs(bench.dynamic_experiment(mesh=mesh, maintenance="shared"))
        bench = injected_bench(jax_maps, ("stress", "dynamic"))
        out["injected/stress"] = csvs(bench.stress_experiment(mesh=mesh, maintenance="shared"))
        out["injected/dynamic"] = csvs(bench.dynamic_experiment(mesh=mesh, maintenance="shared"))
        if auto:
            bench = injected_bench(jax_maps, ())
            out["auto/stress"] = csvs(bench.stress_experiment(mesh=mesh))
            out["auto/dynamic"] = csvs(bench.dynamic_experiment(mesh=mesh))
            out["auto/insert-growth"] = csvs(bench.insert_growth_experiment(mesh=mesh))
        return out
''')

# Runs ``_SCENARIO`` on S gloo ranks; rank 0 prints the rows as JSON.
_SPAWN = textwrap.dedent('''
    import json, os, sys
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, world, store_path, out_dir, auto):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        try:
            from repro_torch.launch.mesh import make_replay_mesh
            ns = {}
            exec(open(os.path.join(out_dir, "scenario.py")).read(), ns)
            out = ns["run_tables"](make_replay_mesh(device="cpu"),
                                   os.path.join(out_dir, "jax_maps.npz"), auto)
            if rank == 0:
                print(json.dumps(out), flush=True)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        world, out_dir, auto = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "auto"
        mp.spawn(rank_main, args=(world, os.path.join(out_dir, "store"), out_dir, auto),
                 nprocs=world)
''')


def _jax_bench_module():
    spec = importlib.util.spec_from_file_location(
        "jax_paper_tables_mesh", ROOT / "benchmarks" / "paper_tables.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX bench's meshless Stress, Dynamic and Insert-growth rows, and
    an npz of its DiDiC partitions, states and each run's maintained maps."""
    bench = _jax_bench_module().PaperBench(JaxConfig(**SIZE))
    maps = {}
    make = bench._runtime_for
    current = []

    def recording(*args, **kwargs):
        runtime = make(*args, **kwargs)
        inner = runtime.service.runtime.maintain
        run_maps = []
        current[-1].append(run_maps)

        def maintain(*a, **kw):
            out = inner(*a, **kw)
            run_maps.append(np.array(out, copy=True))
            return out

        runtime.service.runtime.maintain = maintain
        return runtime

    bench._runtime_for = recording
    rows = {}
    for table, fn in (("stress", bench.stress_experiment), ("dynamic", bench.dynamic_experiment),
                      ("insert-growth", bench.insert_growth_experiment)):
        current.append([])
        rows[table] = fn()
        maps[table] = current[-1]
    arrays = {}
    for name in ("filesystem", "gis", "twitter"):
        arrays[f"parts/{name}"] = np.asarray(bench._parts[(name, "didic", 4)])
        st = bench._parts[(name, "didic_state", 4)]
        for f in ("w", "l", "parts", "beta"):
            arrays[f"state/{name}/{f}"] = np.asarray(getattr(st, f))
    for table in SHARED:
        arrays[f"maps/{table}"] = np.asarray(len(maps[table]))
        for i, run_maps in enumerate(maps[table]):
            arrays[f"maps/{table}/{i}"] = np.asarray(len(run_maps))
            for j, m in enumerate(run_maps):
                arrays[f"maps/{table}/{i}/{j}"] = m
    path = tmp_path_factory.mktemp("jax_tables") / "jax_maps.npz"
    np.savez(path, **arrays)
    return rows, path


@pytest.fixture(scope="module")
def meshless():
    bench = paper_tables.PaperBench(PaperExperimentConfig(**SIZE), device="cpu")
    return {"stress": bench.stress_experiment(), "dynamic": bench.dynamic_experiment()}


@pytest.fixture(scope="module")
def group():
    """One gloo rank in this process, closed after the module's tests."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _spawn(world: int, tmp: pathlib.Path, jax_maps: pathlib.Path, auto: bool):
    (tmp / "scenario.py").write_text(_SCENARIO)
    (tmp / "spawn.py").write_text(_SPAWN)
    (tmp / "jax_maps.npz").write_bytes(jax_maps.read_bytes())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(tmp / "spawn.py"), str(world), str(tmp),
                          "auto" if auto else "shared"],
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def spawned(jax_run, tmp_path_factory):
    """The tables on 2 (with the mesh DiDiC) or 4 spawned ranks, each run
    once however many tests read it."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = _spawn(world, tmp_path_factory.mktemp(f"tables{world}"), jax_run[1],
                                 auto=world == 2)
        return runs[world]

    return get


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda s: f"S{s}")
def mesh_rows(request, jax_run, spawned):
    world = request.param
    if world > 1:
        return spawned(world)
    request.getfixturevalue("group")
    from repro_torch.launch.mesh import make_replay_mesh

    ns = {}
    exec(_SCENARIO, ns)
    return ns["run_tables"](make_replay_mesh(device="cpu"), str(jax_run[1]), False)


def _split(rows):
    """(every row but cycle_s, the cycle_s rows as (name, derived))."""
    rest, cycle = [], []
    for line in rows:
        name, value, derived = line.split(",", 2)
        if name.endswith("/cycle_s"):
            assert float(value) >= 0, line
            cycle.append((name, derived))
        else:
            rest.append(line)
    return rest, cycle


def _csv(rows):
    return [r.csv() for r in rows]


@pytest.mark.parametrize("table", SHARED)
def test_shared_rows_equal_the_meshless_rows(mesh_rows, meshless, table):
    assert mesh_rows["world"] in (1, 2, 4)
    got, got_cycle = _split(mesh_rows[f"shared/{table}"])
    want, want_cycle = _split(_csv(meshless[table]))
    assert got == want and len(got) > 0
    assert got_cycle == [(n, d + MESH_DERIVED) for n, d in want_cycle]
    assert len(got_cycle) == (3 if table == "dynamic" else 0)


@pytest.mark.parametrize("table", SHARED)
def test_shared_rows_with_jax_maps_equal_the_jax_rows(mesh_rows, jax_run, table):
    got, got_cycle = _split(mesh_rows[f"injected/{table}"])
    want, want_cycle = _split(_csv(jax_run[0][table]))
    assert got == want and len(got) > 0
    assert got_cycle == [(n, d + MESH_DERIVED) for n, d in want_cycle]


T_G_ROWS = ("/percent_global", "/base_pg", "/damaged_pg", "/repaired_pg")


@pytest.mark.parametrize("table", AUTO)
def test_mesh_didic_rows_in_the_band_of_jax(jax_run, spawned, table):
    got = spawned(2)[f"auto/{table}"]
    want = _csv(jax_run[0][table])
    names = [line.split(",", 1)[0] for line in got]
    assert names == [r.split(",", 1)[0] for r in want]
    assert names == paper_tables.row_names(PaperExperimentConfig(**SIZE), table)
    checked = 0
    for line, ref in zip(got, want):
        name, value, derived = line.split(",", 2)
        _, ref_value, ref_derived = ref.split(",", 2)
        if name.endswith("/cycle_s"):
            assert derived == ref_derived + MESH_DERIVED
            continue
        assert derived == ref_derived, name
        if name.endswith(T_G_ROWS):
            port, jax = float(value) / 100, float(ref_value) / 100
            assert abs(port - jax) <= 0.25 * jax + 0.01, (name, port, jax)
            checked += 1
        elif name.endswith("/grown_vertices"):
            assert value == ref_value, name
    assert checked == {"stress": 9, "dynamic": 15, "insert-growth": 18}[table]

