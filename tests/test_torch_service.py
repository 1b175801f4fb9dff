"""Port parity for the static service and the quickstart entry point."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import partitioners as jax_partitioners
from repro.core.framework import PartitionedGraphService as JaxService
from repro.graphs import datasets as jax_datasets
from repro_torch.core.framework import PartitionedGraphService
from repro_torch.graphs import datasets

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_quickstart_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.quickstart", "--device", "cpu", "--scale", "0.002"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("Graph(twitter)")
    assert any(line.strip().startswith("random:") for line in lines)
    assert any(line.strip().startswith("didic:") for line in lines)


def test_profile_replay_runs_on_cpu(capsys):
    from repro_torch import profile_replay

    record = profile_replay.main(["--device", "cpu", "--scale", "0.002", "--n-ops", "20",
                                  "--didic-iterations", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"profile": "gis gis_short')
    assert record["wall_s"] > 0
    # The CPU has no device timeline: nothing is booked as device time.
    assert record["device_busy_s"] == 0 and record["device_busy_share"] is None


@pytest.mark.parametrize("parts_kind", ["random", "hardcoded"])
@pytest.mark.parametrize("name,pattern,n_ops", [
    ("filesystem", None, 300), ("gis", "gis_short", 80), ("gis", "gis_long", 20),
])
def test_service_matches_jax_service(name, pattern, n_ops, parts_kind):
    k = 4
    g = datasets.load(name, scale=0.003)
    jg = jax_datasets.load(name, scale=0.003)
    parts = (jax_partitioners.random_partition(jg.n_nodes, k, seed=1) if parts_kind == "random"
             else jax_partitioners.hardcoded_for(jg, k))
    jsvc = JaxService(jg, k).partition_with(parts)
    svc = PartitionedGraphService(g, k, device="cpu").partition_with(parts)
    jops = jsvc.make_ops(n_ops=n_ops, seed=2, pattern=pattern)
    ops = svc.make_ops(n_ops=n_ops, seed=2, pattern=pattern)
    assert ops.fingerprint() == jops.fingerprint()

    want = jsvc.run_ops(jops, engine="batched")
    for engine in ("batched", "scalar"):
        got = svc.run_ops(ops, engine=engine)
        for field in ("per_op_total", "per_op_global", "per_partition", "per_vertex"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert svc.report() == jsvc.report()
    jsvc.run_ops(jops, engine="batched")  # the port service observed two replays
    assert svc.logger.percent_global() == jsvc.logger.percent_global()
    assert svc.logger.load_balance_cv() == jsvc.logger.load_balance_cv()
    assert [vars(i) for i in svc.logger.infos] == [vars(i) for i in jsvc.logger.infos]
