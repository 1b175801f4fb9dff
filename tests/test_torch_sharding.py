"""The port's sharding rules and two-axis mesh, against the JAX package.

Every spec function of ``repro_torch.distributed.sharding`` is held leaf by
leaf to ``repro.distributed.sharding`` (a ``PartitionSpec`` read as a
tuple): the LM rules on a dense and an MoE ``TransformerConfig`` (shared
expert included) and on MACE's tree, DIN's rules, the optimizer state, the
replicated specs and the batch, KV-cache and node specs. Then the mesh:
``make_host_mesh`` lays ranks out as ``jax.make_mesh`` lays devices out,
its collectives (``all_reduce``, ``all_gather``, ``reduce_scatter``) run
along one axis, and ``shard_tree`` then ``gather_tree`` round-trips a tree
bit for bit at 4 gloo ranks on a 2×2 mesh (and at 2×1 and 1×2 layouts of
the same ranks' meshes), with the LM specs.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.distributed import sharding as jax_sharding
from repro.models import mace as jax_mace
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_transformer
from repro.models.moe import MoeConfig as JaxMoeConfig
from repro_torch.distributed import sharding
from repro_torch.models import mace, recsys, transformer
from repro_torch.models.moe import MoeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _jax_flat(specs):
    """path → spec as a tuple, over a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))
    return {jax_sharding._path_str(path): tuple(s) for path, s in flat}


def _port_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _lm_configs():
    kw = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128)
    moe = dict(n_experts=4, top_k=2, d_ff=16, n_shared=1)
    return {
        "dense": (jax_transformer.TransformerConfig(**kw), transformer.TransformerConfig(**kw)),
        "moe": (jax_transformer.TransformerConfig(moe=JaxMoeConfig(**moe), **kw),
                transformer.TransformerConfig(moe=MoeConfig(**moe), **kw)),
    }


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_lm_param_specs_equal_jax_leaf_by_leaf(name):
    jcfg, cfg = _lm_configs()[name]
    want = _jax_flat(jax_sharding.lm_param_specs(jax_transformer.init_abstract(jcfg)))
    got = _port_flat(sharding.lm_param_specs(transformer.init_abstract(cfg)))
    assert got == want
    if name == "moe":  # expert stacks on E (after L); the shared expert keeps the TP rules
        assert got["layers.moe.w_gate"] == (None, "model", None, None)
        assert got["layers.moe.shared.w_down"] == (None, "model", None)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_optimizer_and_replicated_specs_equal_jax(name):
    jcfg, cfg = _lm_configs()[name]
    jspecs = jax_sharding.lm_param_specs(jax_transformer.init_abstract(jcfg))
    specs = sharding.lm_param_specs(transformer.init_abstract(cfg))
    assert _port_flat(sharding.opt_state_specs(specs)) == _jax_flat(jax_sharding.opt_state_specs(jspecs))
    jrep = jax_sharding.replicated_specs(jax_transformer.init_abstract(jcfg))
    assert _port_flat(sharding.replicated_specs(transformer.init_abstract(cfg))) == _jax_flat(jrep)


def test_lm_rules_on_the_mace_tree_equal_jax():
    # ``species_embed`` is not an LM embedding: the rule excludes it.
    jcfg = jax_mace.MaceConfig(n_layers=2, d_hidden=8)
    cfg = mace.MaceConfig(n_layers=2, d_hidden=8)
    jp = jax_mace.init(jcfg, jax.random.PRNGKey(0))
    p = mace.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = _port_flat(sharding.lm_param_specs(p))
    assert got == _jax_flat(jax_sharding.lm_param_specs(jp))
    assert got["species_embed"] == (None, None)


def test_din_param_specs_equal_jax():
    kw = dict(n_items=64, n_cats=8, embed_dim=4, seq_len=5, attn_mlp=(8, 4), mlp=(8, 4))
    jp = jax_recsys.init(jax_recsys.DinConfig(**kw), jax.random.PRNGKey(0))
    p = recsys.init(recsys.DinConfig(**kw), torch.Generator().manual_seed(0), device="cpu")
    got = _port_flat(sharding.din_param_specs(p))
    assert got == _jax_flat(jax_sharding.din_param_specs(jp))
    assert got["item_embed"] == ("model", None) and got["mlp.w0"] == (None, None)


@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model")], ids=["pod1", "multipod"])
def test_batch_cache_node_specs_equal_jax(axes):
    jmesh = jax.make_mesh((1,) * len(axes), axes)
    mesh = types.SimpleNamespace(shape={a: 1 for a in axes})  # the rules read only the axis names
    assert sharding.batch_axes(mesh) == jax_sharding.batch_axes(jmesh)
    for fn in ("lm_batch_spec", "kv_cache_spec", "gnn_node_spec"):
        assert getattr(sharding, fn)(mesh) == tuple(getattr(jax_sharding, fn)(jmesh)), fn


def test_spec_normalises_like_partition_spec():
    for entries in [(("data",), None), ((), "model"), (("pod", "data"), None, "model")]:
        assert sharding.spec(*entries) == tuple(P(*entries))


def test_make_host_mesh_without_a_group_raises():
    # runs before the module's group opens
    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(device="cpu")


# ---------------------------------------------------------------------------
# One rank, in-process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_places_without_copies(mesh):
    from repro_torch.launch.mesh import make_host_mesh

    assert (mesh.size, mesh.shape, mesh.axis_names) == (1, {"data": 1, "model": 1}, ("data", "model"))
    with pytest.raises(ValueError, match="model axis"):
        make_host_mesh(model=2, device="cpu")
    _, cfg = _lm_configs()["moe"]
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = sharding.lm_param_specs(params)
    placed = sharding.shard_tree(params, specs, mesh)
    back = sharding.gather_tree(placed, specs, mesh)
    for a, b, c in zip(_port_flat(params).values(), _port_flat(placed).values(), _port_flat(back).values()):
        assert a is b and b is c


def test_shard_tree_rejects_what_does_not_fit():
    wide = types.SimpleNamespace(shape={"data": 1, "model": 4}, axis_index=lambda axes: 0)
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_tree({"w": torch.zeros(6, 2)}, {"w": ("model", None)}, wide)
    with pytest.raises(ValueError, match="more entries"):
        sharding.shard_tree({"w": torch.zeros(6)}, {"w": ("model", None)}, wide)


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------
_RANK = textwrap.dedent('''
    import json, os, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + k + ".") if isinstance(v, dict) else {prefix + k: v})
        return out


    def rank_main(rank, world, store_path, out_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        try:
            from repro_torch.distributed import sharding
            from repro_torch.launch.mesh import make_host_mesh
            from repro_torch.models import transformer
            from repro_torch.models.moe import MoeConfig

            out = {}
            cfg = transformer.TransformerConfig(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                                                vocab=128, moe=MoeConfig(n_experts=4, top_k=2, d_ff=16,
                                                                         n_shared=1))
            params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            specs = sharding.lm_param_specs(params)
            for model in (2, 1, 4):
                mesh = make_host_mesh(model=model, device="cpu")
                rec = {"shape": mesh.shape, "coords": mesh.coords(rank),
                       "data_index": mesh.axis_index("data"), "model_index": mesh.axis_index("model")}
                # collectives along one axis: the sum of ranks and the gather order
                r = torch.tensor([float(rank)])
                rec["sum"] = {str(a): mesh.all_reduce(r, axis=a).item()
                              for a in ("data", "model", None, ("data", "model"))}
                rec["gather"] = {str(a): [int(t.item()) for t in mesh.all_gather(r, axis=a)]
                                 for a in ("data", "model", None, ("model", "data"))}
                rec["scatter"] = {}
                for a in ("data", "model", None, ("model", "data")):
                    k = len(mesh.all_gather(r, axis=a))
                    t = torch.tensor([100.0 * rank + i for i in range(k)])
                    rec["scatter"][str(a)] = mesh.reduce_scatter(t, axis=a).tolist()
                placed = sharding.shard_tree(params, specs, mesh)
                back = sharding.gather_tree(placed, specs, mesh)
                rec["round_trip"] = all(torch.equal(a, b) for a, b in
                                        zip(flat(params).values(), flat(back).values()))
                # this rank's slice is the block at its index along each split axis
                want = {}
                for path, leaf in flat(params).items():
                    s = flat(specs)[path]
                    for dim, entry in enumerate(s):
                        if entry is None:
                            continue
                        n = mesh.shape[entry] if isinstance(entry, str) else int(np.prod([mesh.shape[a] for a in entry]))
                        size = leaf.shape[dim] // n
                        leaf = leaf.narrow(dim, mesh.axis_index(entry) * size, size)
                    want[path] = leaf
                rec["slices"] = all(torch.equal(flat(placed)[p], want[p]) for p in want)
                rec["local_shapes"] = {p: list(t.shape) for p, t in flat(placed).items()
                                       if p in ("embed", "layers.moe.w_gate", "layers.attn.wq", "ln_f.scale")}
                rec["shared_shapes"] = {p: list(t.shape) for p, t in flat(placed).items()
                                        if p in ("layers.moe.shared.w_gate", "layers.moe.shared.w_down")}
                out[str(model)] = rec
            gathered = [None] * world
            dist.all_gather_object(gathered, out)
            if rank == 0:
                print(json.dumps(gathered), flush=True)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        world, out_dir = int(sys.argv[1]), sys.argv[2]
        mp.spawn(rank_main, args=(world, os.path.join(out_dir, "store"), out_dir), nprocs=world)
''')


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding4")
    (tmp / "ranks.py").write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(tmp / "ranks.py"), "4", str(tmp)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("model", [2, 1, 4])
def test_host_mesh_lays_ranks_out_as_jax_make_mesh(four_ranks, model):
    devices = np.arange(4).reshape(4 // model, model)  # jax.make_mesh's device grid
    for rank, rec in enumerate(four_ranks):
        rec = rec[str(model)]
        (d,), (m,) = np.nonzero(devices == rank)
        assert rec["shape"] == {"data": 4 // model, "model": model}
        assert rec["coords"] == {"data": int(d), "model": int(m)}
        assert (rec["data_index"], rec["model_index"]) == (int(d), int(m))


@pytest.mark.parametrize("model", [2, 1, 4])
def test_host_mesh_collectives_run_along_one_axis(four_ranks, model):
    devices = np.arange(4).reshape(4 // model, model)
    for rank, rec in enumerate(four_ranks):
        rec = rec[str(model)]
        (d,), (m,) = np.nonzero(devices == rank)
        column, row = devices[:, m].tolist(), devices[d, :].tolist()
        assert rec["sum"] == {"data": sum(column), "model": sum(row), "None": 6, "('data', 'model')": 6}
        assert rec["gather"]["data"] == column and rec["gather"]["model"] == row
        assert rec["gather"]["None"] == [0, 1, 2, 3]
        assert rec["gather"]["('model', 'data')"] == devices.T.reshape(-1).tolist()
        for a, members in (("data", column), ("model", row), ("None", [0, 1, 2, 3]),
                           ("('model', 'data')", devices.T.reshape(-1).tolist())):
            idx = members.index(rank)  # block idx of every member's t, summed
            assert rec["scatter"][a] == [100.0 * sum(members) + len(members) * idx]


@pytest.mark.parametrize("model", [2, 1, 4])
def test_shard_then_gather_round_trips(four_ranks, model):
    for rec in four_ranks:
        rec = rec[str(model)]
        assert rec["round_trip"] and rec["slices"]
        data = 4 // model
        assert rec["local_shapes"] == {"embed": [128 // model, 32], "layers.attn.wq": [2, 32, 32 // model],
                                       "layers.moe.w_gate": [2, 4 // model, 32, 16], "ln_f.scale": [32]}
        assert rec["shared_shapes"] == {"layers.moe.shared.w_gate": [2, 32, 16 // model],
                                        "layers.moe.shared.w_down": [2, 16 // model, 32]}
        assert data * model == 4
