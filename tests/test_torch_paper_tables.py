"""Port parity for the paper's tables: ``repro_torch.paper_tables`` against
the JAX package's ``benchmarks/paper_tables.py``, on the CPU.

Three benches run once each, at a small size: the JAX bench; the port's
own (uninjected); and the port's with the JAX run's DiDiC partitions and
diffusion states put into ``_parts`` and each dynamic run's maintained maps
supplied from the JAX run (the port's ``runtime.maintain`` is replaced, as
in ``test_torch_dynamic.py``).

What is held: every table's row names, in order; uninjected, the rows of
the random and hard-coded partitions and every Eq. 7.3 row, ``csv()`` for
``csv()``; injected, every row but the timings (``cycle_s`` and
``maintenance_cost``). The port's own DiDiC sums floats in another order,
so uninjected DiDiC T_G % rows are held to the band
``|port − ref| ≤ 0.25·ref + 0.01`` (as fractions).
"""

import importlib.util
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.paper_didic import PaperExperimentConfig as JaxConfig
from repro_torch import convert
from repro_torch import paper_tables
from repro_torch.configs.paper_didic import PaperExperimentConfig

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE = dict(scale=0.002, didic_iterations=10, n_ops=200, n_ops_gis=40)
TABLES = ("7.1", "7.2", "static", "corr", "insert", "insert-growth", "stress", "dynamic", "maint")
TIMINGS = ("/cycle_s", "maintenance/")


def _jax_bench_module():
    spec = importlib.util.spec_from_file_location(
        "jax_paper_tables", ROOT / "benchmarks" / "paper_tables.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def _run_tables(bench, tables):
    return {key: tables[key]() for key in TABLES}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX bench's rows per table, its DiDiC partitions and states, and
    the maintained maps of each dynamic run, in the order the runs start."""
    bench = _jax_bench_module().PaperBench(JaxConfig(**SIZE))
    maps = []
    make = bench._runtime_for

    def recording(*args, **kwargs):
        runtime = make(*args, **kwargs)
        inner = runtime.service.runtime.maintain
        run_maps = []
        maps.append(run_maps)

        def maintain(*a, **kw):
            out = inner(*a, **kw)
            run_maps.append(np.array(out, copy=True))
            return out

        runtime.service.runtime.maintain = maintain
        return runtime

    bench._runtime_for = recording
    tables = {
        "7.1": bench.table_7_1, "7.2": bench.tables_7_2_to_7_4, "static": bench.static_traffic,
        "corr": bench.correlation_check, "insert": bench.insert_experiment,
        "insert-growth": bench.insert_growth_experiment, "stress": bench.stress_experiment,
        "dynamic": bench.dynamic_experiment, "maint": bench.maintenance_cost,
    }
    return _run_tables(bench, tables), dict(bench._parts), maps


@pytest.fixture(scope="module")
def port_rows():
    bench = paper_tables.PaperBench(PaperExperimentConfig(**SIZE), device="cpu")
    return _run_tables(bench, bench.tables())


@pytest.fixture(scope="module")
def injected_rows(jax_run):
    _, jparts, maps = jax_run
    bench = paper_tables.PaperBench(PaperExperimentConfig(**SIZE), device="cpu")
    for key, value in jparts.items():
        name, method, k = key
        if method == "didic":
            bench._parts[key] = np.asarray(value, dtype=np.int32)
        elif method == "didic_state":
            bench._parts[key] = convert.didic_state_from_arrays(
                np.asarray(value.w), np.asarray(value.l), np.asarray(value.parts),
                np.asarray(value.beta), device="cpu")
    supply = iter(maps)
    make = bench._runtime_for

    def injected(*args, **kwargs):
        runtime = make(*args, **kwargs)
        run_maps = iter(next(supply))
        runtime.service.runtime.maintain = lambda *a, **kw: next(run_maps)
        return runtime

    bench._runtime_for = injected
    rows = _run_tables(bench, bench.tables())
    assert next(supply, None) is None, "the port started fewer dynamic runs than the JAX bench"
    return rows


def _names(rows):
    return [r.name for r in rows]


def _timing(row):
    return any(t in row.name for t in TIMINGS)


@pytest.mark.parametrize("table", TABLES)
def test_row_names_match_jax(jax_run, port_rows, table):
    want = _names(jax_run[0][table])
    assert _names(port_rows[table]) == want
    assert paper_tables.row_names(PaperExperimentConfig(**SIZE), table) == want


@pytest.mark.parametrize("table", ["7.1", "7.2", "static", "corr"])
def test_static_rows_match_jax_uninjected(jax_run, port_rows, table):
    """Rows of the random and hard-coded partitions, and every Eq. 7.3 row
    (it replays the random map), are the same strings without injection."""
    want = [r.csv() for r in jax_run[0][table] if "/didic/" not in r.name]
    got = [r.csv() for r in port_rows[table] if "/didic/" not in r.name]
    assert got == want and len(got) > 0


@pytest.mark.parametrize("table", ["7.1", "7.2", "static", "insert", "insert-growth", "stress",
                                   "dynamic"])
def test_rows_match_jax_injected(jax_run, injected_rows, table):
    """With the JAX DiDiC partitions, states and maintained maps, every row
    is the same string; only wall-clock rows are left out."""
    want = [r.csv() for r in jax_run[0][table] if not _timing(r)]
    got = [r.csv() for r in injected_rows[table] if not _timing(r)]
    assert got == want and len(got) > 0


def test_didic_traffic_in_the_reference_band(jax_run, port_rows):
    """The port's own DiDiC: each dataset's and k's T_G % within
    ``0.25·ref + 0.01`` of the JAX bench's, and below random's."""
    want = {r.name: r.value for r in jax_run[0]["static"]}
    got = {r.name: r.value for r in port_rows["static"]}
    didic = [n for n in want if n.endswith("/didic/percent_global")]
    assert len(didic) == 6
    for name in didic:
        ref, port = want[name] / 100, got[name] / 100
        assert abs(port - ref) <= 0.25 * ref + 0.01, (name, port, ref)
        assert port < got[name.replace("/didic/", "/random/")] / 100


@pytest.mark.parametrize("table", ["dynamic", "maint"])
def test_timing_rows_are_positive(port_rows, table):
    timed = [r for r in port_rows[table] if _timing(r)]
    assert len(timed) == 3
    for r in timed:
        assert math.isfinite(r.value) and r.value > 0, r


def test_all_tables_adds_a_timing_row_per_table(monkeypatch):
    bench = paper_tables.PaperBench(PaperExperimentConfig(**SIZE), device="cpu")
    fns = [fn.__name__ for fn in bench.tables().values()]

    def stub(name):
        def table():
            return [paper_tables.Row(name, 1.0)]
        table.__name__ = name
        return table

    for name in fns:
        monkeypatch.setattr(bench, name, stub(name))
    rows = bench.all_tables()
    assert [r.name for r in rows[0::2]] == fns
    assert [r.name for r in rows[1::2]] == [f"_timing/{n}_s" for n in fns]


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.paper_tables", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)


def test_cli_prints_the_reference_header_and_rows():
    out = _cli("--device", "cpu", "--scale", "0.002", "--tables", "7.1,corr",
               "--didic-iters", "5")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    cfg = PaperExperimentConfig(scale=0.002, didic_iterations=5)
    assert lines[0] == "name,value,derived"
    names = paper_tables.row_names(cfg, "7.1") + paper_tables.row_names(cfg, "corr")
    assert [line.split(",")[0] for line in lines[1:-1]] == names
    assert lines[-1].startswith("_total_wall_s,")


@pytest.mark.parametrize("table", ["kernels", "roofline"])
def test_cli_refuses_the_tpu_rows(table):
    out = _cli("--device", "cpu", "--tables", table, timeout=120)
    assert out.returncode != 0
    assert "PERF.md" in out.stderr and out.stdout == ""


def test_bench_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paper_tables.PaperBench(PaperExperimentConfig(**SIZE))
