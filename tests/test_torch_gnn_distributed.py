"""The distributed GCN (``repro_torch.distributed_gnn_training``, the twin of
``examples/distributed_gnn_training.py``) and the differentiable halo
exchange, against the JAX package.

The JAX example's own sharded loop raises under JAX 0.9 (its
``value_and_grad`` through the sharded SpMM), so its oracle is the same
loop on one JAX device with the halo SpMM replaced by the same product
unsharded, in layout order (built here from ``repro`` functions and
``repro.optim.adamw``). The JAX DiDiC map and the JAX initial parameters
go into the port's run. Held: the halo table equals
``collective_bytes_estimate``; the halo SpMM's forward and input gradient
at 4 gloo ranks equal the dense product's within 1e-5, on a (4, 1) mesh
and on a (2, 2) one (two data shards, each held by the two ranks of its
column); the twin's losses over 10 steps at 1 rank and at 4 ranks on both
meshes equal the JAX loop's within 1e-5.
"""

import os
import pathlib
import subprocess
import sys
import textwrap
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import partitioners as jax_partitioners
from repro.core.didic import DidicConfig as JaxDidicConfig
from repro.core.didic import didic_partition as jax_didic_partition
from repro.data.pipeline import gnn_features as jax_gnn_features
from repro.distributed.placement import build_layout as jax_build_layout
from repro.distributed.placement import collective_bytes_estimate as jax_bytes_estimate
from repro.graphs import datasets as jax_datasets
from repro.models import gnn as jax_gnn
from repro.optim import adamw as jax_adamw
from repro_torch import distributed_gnn_training as twin
from repro_torch.convert import gnn_params_from_arrays
from repro_torch.core import partitioners
from repro_torch.graphs import datasets

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCALE, STEPS = 0.003, 10
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_run():
    """The example's graph, its DiDiC map and initial GCN, and 10 steps of
    its loop on one JAX device with the SpMM unsharded in layout order."""
    graph = jax_datasets.load("gis", scale=SCALE)
    parts, _ = jax_didic_partition(graph, JaxDidicConfig(k=4, iterations=40), seed=0)
    parts = np.asarray(parts)
    layout = jax_build_layout(graph, parts, 4)
    s, r, w = graph.undirected
    src, dst = jnp.asarray(layout.old_to_new[s]), jnp.asarray(layout.old_to_new[r])
    w = jnp.asarray(w)[:, None]

    def spmm(h):
        return jax.ops.segment_sum(w * h[src], dst, num_segments=layout.padded_n)

    x_host, labels = jax_gnn_features(graph.n_nodes, 32, 4, seed=0)
    x = jnp.asarray(layout.scatter_features(x_host))
    y = jnp.asarray(layout.scatter_features(labels.astype(np.int32), fill=-1))
    mask = (y >= 0).astype(jnp.float32)
    y = jnp.maximum(y, 0)
    cfg = jax_gnn.GnnConfig(kind="gcn", d_in=32, d_hidden=32, d_out=4)
    params0 = jax_gnn.gcn_init(cfg, jax.random.PRNGKey(0))
    opt_cfg = jax_adamw.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=60, weight_decay=0.0)

    def forward(p, x):
        h = x
        for i in range(cfg.n_layers):
            h = h @ p[f"w{i}"]
            h = spmm(h) + h
            if i < cfg.n_layers - 1:
                h = jax.nn.relu(h)
        return h

    def loss_fn(p):
        logp = jax.nn.log_softmax(forward(p, x).astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return (nll * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    @jax.jit
    def train_step(p, st):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        p, st, _ = jax_adamw.update(p, grads, st, opt_cfg)
        return p, st, loss

    params, state, losses = params0, jax_adamw.init(params0), []
    for _ in range(STEPS):
        params, state, loss = train_step(params, state)
        losses.append(float(loss))
    return {"parts": parts, "params": {k: np.asarray(v) for k, v in params0.items()},
            "losses": np.asarray(losses), "graph": graph}


def test_halo_table_equals_jax(jax_run):
    g = datasets.load("gis", scale=SCALE)
    rand = partitioners.random_partition(g.n_nodes, 4, seed=0)
    got = twin.halo_table(g, {"random": rand, "didic": jax_run["parts"]})
    jg = jax_run["graph"]
    jrand = np.asarray(jax_partitioners.random_partition(jg.n_nodes, 4, seed=0))
    np.testing.assert_array_equal(rand, jrand)
    for name, parts in (("random", jrand), ("didic", jax_run["parts"])):
        assert got[name] == jax_bytes_estimate(jg, parts, d_feat=32), name
    # the example's figures: DiDiC cuts the halo bytes of a random placement
    assert got["didic"][0] < 0.25 * got["random"][0] and got["didic"][1] < 0.1 < got["random"][1]


def test_cli_runs_on_its_own_group(capsys):
    # runs before the module's group opens
    assert not dist.is_initialized()
    run = twin.main(["--device", "cpu", "--steps", "3", "--scale", "0.002"])
    out = capsys.readouterr().out
    assert "placement/random" in out and "placement/didic" in out and "step   2: loss=" in out
    assert len(run.losses) == 3 and not dist.is_initialized()


@pytest.fixture(scope="module")
def one_rank():
    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_one_rank_losses_equal_the_jax_loop(jax_run, one_rank):
    g = datasets.load("gis", scale=SCALE)
    params = gnn_params_from_arrays(jax_run["params"], "gcn", 2, device="cpu")
    run = twin.train(g, jax_run["parts"], one_rank, steps=STEPS, params=params)
    assert run.layout.n_shards == 1 and run.program.halo_bytes(32) == 4 * 32  # one padded boundary row
    np.testing.assert_allclose(run.losses, jax_run["losses"], rtol=0, atol=1e-5)
    assert run.losses[-1] < run.losses[0]
    assert [s for s, _, _ in run.evals] == [0, 9]


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------
_RANKS = textwrap.dedent('''
    import os, sys
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
            from repro_torch import distributed_gnn_training as twin
            from repro_torch.convert import gnn_params_from_arrays
            from repro_torch.distributed.halo import build_halo_program, make_partitioned_spmm
            from repro_torch.distributed.placement import build_layout
            from repro_torch.graphs import datasets
            from repro_torch.launch.mesh import make_host_mesh

            inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
            mesh = make_host_mesh(device="cpu")
            g = datasets.load("gis", scale=float(inputs["scale"]))
            saved = {}

            # the halo SpMM and its input gradient on this rank's block
            layout = build_layout(g, inputs["parts"], world)
            prog = build_halo_program(g, layout)
            spmm = make_partitioned_spmm(prog, mesh)
            rows = slice(rank * layout.block, (rank + 1) * layout.block)
            x = torch.as_tensor(inputs["x"][rows]).requires_grad_()
            out = spmm(x)
            (grad,) = torch.autograd.grad((out * torch.as_tensor(inputs["r"][rows])).sum(), x)
            saved["spmm"] = torch.cat(mesh.all_gather(out.detach())).numpy()
            saved["grad"] = torch.cat(mesh.all_gather(grad)).numpy()
            saved["block"] = np.asarray(layout.block)

            params = gnn_params_from_arrays({k[2:]: v for k, v in inputs.items() if k.startswith("p/")},
                                            "gcn", 2, device="cpu")
            run = twin.train(g, inputs["parts"], mesh, steps=int(inputs["steps"]), params=params)
            saved["losses"] = np.asarray(run.losses)
            saved["b_max"] = np.asarray(run.program.b_max)

            # a (2, 2) mesh: two data shards, the exchange within each model column
            mesh2 = make_host_mesh(model=2, device="cpu")
            layout2 = build_layout(g, inputs["parts"], mesh2.shape["data"])
            spmm2 = make_partitioned_spmm(build_halo_program(g, layout2), mesh2)
            d = mesh2.axis_index("data")
            rows2 = slice(d * layout2.block, (d + 1) * layout2.block)
            x2 = torch.as_tensor(inputs["x2"][rows2]).requires_grad_()
            out2 = spmm2(x2)
            (grad2,) = torch.autograd.grad((out2 * torch.as_tensor(inputs["r2"][rows2])).sum(), x2)
            saved["spmm2"] = torch.cat(mesh2.all_gather(out2.detach(), axis="data")).numpy()
            saved["grad2"] = torch.cat(mesh2.all_gather(grad2, axis="data")).numpy()
            run2 = twin.train(g, inputs["parts"], mesh2, steps=int(inputs["steps"]), params=params)
            saved["losses2"] = np.asarray(run2.losses)
            if rank == 0:
                np.savez(os.path.join(out_dir, "port.npz"), **saved)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        world, out_dir = int(sys.argv[1]), sys.argv[2]
        mp.spawn(rank_main, args=(world, os.path.join(out_dir, "store"), out_dir), nprocs=world)
''')


@pytest.fixture(scope="module")
def four_ranks(jax_run, tmp_path_factory):
    """The four ranks' SpMM, its input gradient and the twin's losses, with
    the dense product's inputs (x, the gradient seed r) in the layout."""
    tmp = tmp_path_factory.mktemp("gnn4")
    g = jax_run["graph"]
    layout = jax_build_layout(g, jax_run["parts"], 4)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(layout.padded_n, 8)).astype(np.float32)
    r = rng.normal(size=(layout.padded_n, 8)).astype(np.float32)
    layout2 = jax_build_layout(g, jax_run["parts"], 2)
    x2 = rng.normal(size=(layout2.padded_n, 8)).astype(np.float32)
    r2 = rng.normal(size=(layout2.padded_n, 8)).astype(np.float32)
    np.savez(tmp / "inputs.npz", scale=SCALE, steps=STEPS, parts=jax_run["parts"], x=x, r=r, x2=x2, r2=r2,
             **{f"p/{k}": v for k, v in jax_run["params"].items()})
    (tmp / "ranks.py").write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(tmp / "ranks.py"), "4", str(tmp)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    s, rr, w = g.undirected

    def dense_product(lay, x, r):
        src, dst = lay.old_to_new[s], lay.old_to_new[rr]
        out, grad = np.zeros_like(x), np.zeros_like(x)
        np.add.at(out, dst, w[:, None] * x[src])
        np.add.at(grad, src, w[:, None] * r[dst])
        return out, grad

    dense, dense_grad = dense_product(layout, x, r)
    return dict(np.load(tmp / "port.npz")), dense, dense_grad, layout, dense_product(layout2, x2, r2)


def test_four_rank_halo_spmm_forward_equals_the_dense_product(four_ranks):
    got, dense, _, layout, _ = four_ranks
    assert int(got["block"]) == layout.block and int(got["b_max"]) > 1
    np.testing.assert_allclose(got["spmm"], dense, rtol=0, atol=1e-5)


def test_four_rank_halo_spmm_input_gradient_equals_the_dense_transpose(four_ranks):
    got, _, dense_grad, _, _ = four_ranks
    np.testing.assert_allclose(got["grad"], dense_grad, rtol=0, atol=1e-5)


def test_four_rank_losses_equal_the_jax_loop(four_ranks, jax_run):
    got = four_ranks[0]
    np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=0, atol=1e-5)


def test_two_by_two_halo_spmm_and_gradient_equal_the_dense_product(four_ranks):
    """On a (2, 2) mesh each data shard is held by the two ranks of its
    column; the exchange runs over the data axis only."""
    got, _, _, _, (dense2, dense_grad2) = four_ranks
    np.testing.assert_allclose(got["spmm2"], dense2, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grad2"], dense_grad2, rtol=0, atol=1e-5)


def test_two_by_two_losses_equal_the_jax_loop(four_ranks, jax_run):
    got = four_ranks[0]
    np.testing.assert_allclose(got["losses2"], jax_run["losses"], rtol=0, atol=1e-5)
