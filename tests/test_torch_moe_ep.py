"""The port's expert-parallel MoE (``moe_fwd_ep``) and the EP forward of the
transformer, against the JAX package's ``moe_fwd_ep`` and
``moe_impl="ep_shardmap"`` (in the port, a mesh passed to ``forward``).

JAX runs in a subprocess on four forced CPU devices, under
``jax.sharding.set_mesh`` of a ``("data", "model")`` mesh of shape (1, 4),
(2, 2) and (4, 1); it draws the inputs and writes them with its outputs.
The port runs the same three meshes on four gloo ranks (each rank its data
shard of the tokens and its expert shard, placed by ``shard_tree``) and
rank 0 writes the outputs gathered over the data axis. Held: y within
1e-5, aux within 1e-6, for an MoE with a shared expert and one whose low
capacity factor drops assignments, and a two-layer MoE transformer's
logits within 1e-5. On one rank, the (1, 1) mesh is bit-equal to
``moe_fwd``, and a call that needs a gradient raises.
"""

import dataclasses
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
MESHES = ((1, 4), (2, 2), (4, 1))
CASES = ("shared", "drops")
torch.set_num_threads(1)

# The configs, written once for both packages (the port's have the same fields).
_CONFIGS = textwrap.dedent('''
    def moe_configs(MoeConfig):
        return {"shared": MoeConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1),
                "drops": MoeConfig(n_experts=8, top_k=2, d_ff=16, capacity_factor=0.25)}


    def lm_config(TransformerConfig, MoeConfig, **kw):
        return TransformerConfig(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
                                 moe=MoeConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1), **kw)
''')

_JAX_EP = _CONFIGS + textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    from repro.models import transformer as T
    from repro.models.moe import MoeConfig, moe_fwd_ep, moe_init

    assert len(jax.devices()) == 4
    out = {}

    def put(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(f"{prefix}{k}/", v)
            else:
                out[prefix + k] = np.asarray(v)

    x = jax.random.normal(jax.random.PRNGKey(1), (4, 32, 32))
    out["x"] = np.asarray(x)
    moe_p = {}
    for i, (name, cfg) in enumerate(moe_configs(MoeConfig).items()):
        moe_p[name] = moe_init(jax.random.PRNGKey(10 + i), 32, cfg)
        put(f"moe_{name}/", moe_p[name])
    # unroll: the scan's carry keeps no data sharding under an explicit mesh
    tcfg = lm_config(T.TransformerConfig, MoeConfig, moe_impl="ep_shardmap", unroll=True)
    tp = T.init_params(tcfg, jax.random.PRNGKey(2))
    put("lm/", tp)
    tokens = jax.random.randint(jax.random.PRNGKey(3), (4, 8), 0, 128)
    out["tokens"] = np.asarray(tokens)
    for shape in ''' + repr(MESHES) + ''':
        tag = f"{shape[0]}x{shape[1]}"
        with jax.sharding.set_mesh(jax.make_mesh(shape, ("data", "model"))):
            for name, cfg in moe_configs(MoeConfig).items():
                y, aux = jax.jit(lambda p, x, cfg=cfg: moe_fwd_ep(p, x, cfg))(moe_p[name], x)
                out[f"y/{name}/{tag}"], out[f"aux/{name}/{tag}"] = np.asarray(y), np.asarray(aux)
            logits, aux = jax.jit(lambda p, t: T.forward(tcfg, p, t))(tp, tokens)
            out[f"logits/{tag}"], out[f"lm_aux/{tag}"] = np.asarray(logits), np.asarray(aux)
    np.savez(sys.argv[1], **out)
''')

_PORT_EP = _CONFIGS + textwrap.dedent('''
    import dataclasses, os, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def tree(arrays, prefix):
        out = {}
        for key, v in arrays.items():
            if key.startswith(prefix):
                node = out
                *path, leaf = key[len(prefix):].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = v
        return out


    def rank_main(rank, world, store_path, out_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        try:
            from repro_torch.convert import transformer_params_from_arrays
            from repro_torch.distributed.sharding import ep_param_specs, lm_batch_spec, shard_tree
            from repro_torch.launch.mesh import make_host_mesh
            from repro_torch.models import transformer as T
            from repro_torch.models.moe import MoeConfig, moe_fwd_ep

            arrays = dict(np.load(os.path.join(out_dir, "jax.npz")))
            x = torch.as_tensor(arrays["x"])
            tokens = torch.as_tensor(arrays["tokens"])
            tcfg = lm_config(T.TransformerConfig, MoeConfig)
            lm = transformer_params_from_arrays(tree(arrays, "lm/"), device="cpu")
            saved = {}
            for shape in ''' + repr(MESHES) + ''':
                tag = f"{shape[0]}x{shape[1]}"
                mesh = make_host_mesh(model=shape[1], device="cpu")
                assert mesh.shape == {"data": shape[0], "model": shape[1]}
                x_loc = shard_tree({"x": x}, {"x": ("data", None, None)}, mesh)["x"]
                with torch.no_grad():
                    for name, cfg in moe_configs(MoeConfig).items():
                        p = {k: torch.as_tensor(v) for k, v in tree(arrays, f"moe_{name}/").items()
                             if not isinstance(v, dict)}
                        if "shared" in tree(arrays, f"moe_{name}/"):
                            p["shared"] = {k: torch.as_tensor(v)
                                           for k, v in tree(arrays, f"moe_{name}/shared/").items()}
                        specs = {"router": (), "w_gate": ("model", None, None), "w_up": ("model", None, None),
                                 "w_down": ("model", None, None),
                                 "shared": {"w_gate": (), "w_up": (), "w_down": ()}}
                        if "shared" not in p:
                            del specs["shared"]
                        y, aux = moe_fwd_ep(shard_tree(p, specs, mesh), x_loc, cfg, mesh)
                        saved[f"y/{name}/{tag}"] = torch.cat(mesh.all_gather(y, axis="data")).numpy()
                        saved[f"aux/{name}/{tag}"] = aux.numpy()
                        saved[f"e_loc/{name}/{tag}"] = np.asarray(shard_tree(p, specs, mesh)["w_gate"].shape[0])
                    placed = shard_tree(lm, ep_param_specs(lm), mesh)
                    tok_loc = shard_tree({"t": tokens}, {"t": lm_batch_spec(mesh)}, mesh)["t"]
                    logits, aux = T.forward(tcfg, placed, tok_loc, mesh=mesh)
                    saved[f"logits/{tag}"] = torch.cat(mesh.all_gather(logits, axis="data")).numpy()
                    saved[f"lm_aux/{tag}"] = aux.numpy()
            if rank == 0:
                np.savez(os.path.join(out_dir, "port.npz"), **saved)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        world, out_dir = int(sys.argv[1]), sys.argv[2]
        mp.spawn(rank_main, args=(world, os.path.join(out_dir, "store"), out_dir), nprocs=world)
''')


def _run(script: str, tmp: pathlib.Path, *args: str, **env_extra):
    path = tmp / f"script{len(list(tmp.iterdir()))}.py"
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
    out = subprocess.run([sys.executable, str(path), *args], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's outputs (and inputs) and the port's four-rank outputs."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    _run(_JAX_EP, tmp, str(tmp / "jax.npz"), JAX_PLATFORMS="cpu")
    _run(_PORT_EP, tmp, "4", str(tmp))
    return dict(np.load(tmp / "jax.npz")), dict(np.load(tmp / "port.npz"))


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", CASES)
def test_moe_fwd_ep_equals_jax(runs, case, shape):
    want, got = runs
    key = f"{case}/{_tag(shape)}"
    assert got[f"e_loc/{key}"] == 8 // shape[1]
    np.testing.assert_allclose(got[f"y/{key}"], want[f"y/{key}"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[f"aux/{key}"], want[f"aux/{key}"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_transformer_ep_forward_equals_jax(runs, shape):
    want, got = runs
    tag = _tag(shape)
    assert got[f"logits/{tag}"].shape == (4, 8, 128)
    np.testing.assert_allclose(got[f"logits/{tag}"], want[f"logits/{tag}"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[f"lm_aux/{tag}"], want[f"lm_aux/{tag}"], rtol=0, atol=1e-6)


def test_cases_cover_drops_and_the_per_shard_aux(runs):
    """The ``drops`` case drops assignments on every mesh (capacity from the
    local token count), and with more than one data shard the aux loss is
    the mean of per-shard losses, not the global one."""
    from repro_torch.models.moe import MoeConfig, capacity, route

    want, _ = runs
    ns = {}
    exec(_CONFIGS, ns)
    cfgs = ns["moe_configs"](MoeConfig)
    p = {k: torch.as_tensor(v) for k, v in want.items() if k.startswith("moe_drops/")}
    p = {k.split("/")[-1]: v for k, v in p.items()}
    x = torch.as_tensor(want["x"])
    for data, _ in MESHES:
        for xs in x.chunk(data):
            xf = xs.reshape(-1, 32)
            _, _, idx, _ = route(p, xf, cfgs["drops"])
            assert torch.bincount(idx.reshape(-1), minlength=8).max() > capacity(xf.shape[0], cfgs["drops"])
    assert want["aux/shared/1x4"] != want["aux/shared/4x1"]


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


@pytest.mark.parametrize("case", CASES)
def test_one_by_one_mesh_is_moe_fwd_bit_for_bit(mesh, case):
    from repro_torch.models.moe import MoeConfig, moe_fwd, moe_fwd_ep, moe_init

    ns = {}
    exec(_CONFIGS, ns)
    cfg = ns["moe_configs"](MoeConfig)[case]
    p = moe_init(torch.Generator().manual_seed(0), 32, cfg, device="cpu")
    x = torch.randn(4, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, aux = moe_fwd_ep(p, x, cfg, mesh)
        y0, aux0 = moe_fwd(p, x, cfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


def test_one_by_one_transformer_ep_is_dense_bit_for_bit(mesh):
    from repro_torch.distributed.sharding import ep_param_specs, shard_tree
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import MoeConfig

    ns = {}
    exec(_CONFIGS, ns)
    cfg = ns["lm_config"](T.TransformerConfig, MoeConfig)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, 128, (2, 8), generator=torch.Generator().manual_seed(1))
    placed = shard_tree(params, ep_param_specs(params), mesh)
    with torch.no_grad():
        logits, aux = T.forward(cfg, placed, tokens, mesh=mesh)
        logits0, aux0 = T.forward(cfg, params, tokens)
    assert torch.equal(logits, logits0) and torch.equal(aux, aux0)
    dense = dataclasses.replace(cfg, moe=None)
    with pytest.raises(ValueError, match="needs an MoE config"):
        T.forward(dense, T.init_params(dense, torch.Generator().manual_seed(0), device="cpu"), tokens,
                  mesh=mesh)


def test_a_gradient_request_raises(mesh):
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import MoeConfig, moe_fwd_ep, moe_init

    cfg = MoeConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1)
    p = moe_init(torch.Generator().manual_seed(0), 32, cfg, device="cpu")
    x = torch.randn(2, 4, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        moe_fwd_ep(p, x.requires_grad_(), cfg, mesh)
    p["shared"]["w_up"].requires_grad_()
    with pytest.raises(NotImplementedError, match="forward only"):
        moe_fwd_ep(p, x.detach(), cfg, mesh)
    tcfg = T.TransformerConfig(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, vocab=64, moe=cfg)
    params = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    params["layers"]["attn"]["wq"].requires_grad_()
    with pytest.raises(NotImplementedError, match="EP backward"):
        T.forward(tcfg, params, torch.zeros(1, 4, dtype=torch.long), mesh=mesh)
