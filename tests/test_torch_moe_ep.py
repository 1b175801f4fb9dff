"""The port's expert-parallel MoE (``moe_fwd_ep``) and the EP forward of the
transformer, against the JAX package's ``moe_fwd_ep`` and
``moe_impl="ep_shardmap"`` (in the port, a mesh passed to ``forward``),
forward and backward.

JAX runs in a subprocess on four forced CPU devices, under
``jax.sharding.set_mesh`` of a ``("data", "model")`` mesh of shape (1, 4),
(2, 2) and (4, 1); it draws the inputs and writes them with its outputs.
The port runs the same three meshes on four gloo ranks (each rank its data
shard of the tokens and its shard of every leaf in the JAX layout, placed
by ``shard_tree``: its experts, and the shared expert and the transformer's
other weights tensor parallel) and rank 0 writes the outputs gathered over
the model and data axes. Held: y within
1e-5, aux within 1e-6, for an MoE with a shared expert and one whose low
capacity factor drops assignments, and a two-layer MoE transformer's
logits within 1e-5. The backward: the gradient of ``sum(y · w) + aux``
in x and every leaf (expert shards gathered over the model axis) against
``jax.grad`` through the JAX ``moe_fwd_ep``, within ``1e-5 · max(1, max
|g|)`` a leaf; an aux-only loss's router gradient within 1e-9 (a model-axis
double count would multiply it); and the two-layer MoE LM's loss, every
gradient and one AdamW update against ``jax.value_and_grad`` of the JAX
dense ``loss_fn`` averaged over the data shards (the JAX LM step under a
mesh raises, ROADMAP C), within the same bar. On one rank, the (1, 1) mesh
is bit-equal to ``moe_fwd``, forward and gradients.
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
    # One AdamW step moves each leaf by up to ~1e-2. Its step is g / (|g| + eps):
    # at the default eps 1e-8 a gradient entry within rounding of zero moves
    # its leaf by up to lr · Δg / eps, so eps 1e-3 keeps the step a smooth
    # function of the gradient (whose own bar the test holds apart).
    OPT = dict(lr=1e-2, warmup_steps=1, eps=1e-3)


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
    import jax.numpy as jnp
    from repro.models import transformer as T
    from repro.models.moe import MoeConfig, moe_fwd_ep, moe_init
    from repro.optim import adamw

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
    labels = jax.random.randint(jax.random.PRNGKey(5), (4, 8), 0, 128)
    out["labels"] = np.asarray(labels)
    w = jax.random.normal(jax.random.PRNGKey(4), (4, 32, 32))
    out["w"] = np.asarray(w)
    for shape in ''' + repr(MESHES) + ''':
        tag = f"{shape[0]}x{shape[1]}"
        with jax.sharding.set_mesh(jax.make_mesh(shape, ("data", "model"))):
            for name, cfg in moe_configs(MoeConfig).items():
                y, aux = jax.jit(lambda p, x, cfg=cfg: moe_fwd_ep(p, x, cfg))(moe_p[name], x)
                out[f"y/{name}/{tag}"], out[f"aux/{name}/{tag}"] = np.asarray(y), np.asarray(aux)

                def loss(p, x, cfg=cfg):
                    y, aux = moe_fwd_ep(p, x, cfg)
                    return jnp.sum(y * w) + aux

                gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(moe_p[name], x)
                put(f"g/{name}/{tag}/", gp)
                out[f"g/{name}/{tag}/x"] = np.asarray(gx)
                ga = jax.jit(jax.grad(lambda p, cfg=cfg: moe_fwd_ep(p, x, cfg)[1]))(moe_p[name])
                out[f"g_aux/{name}/{tag}"] = np.asarray(ga["router"])
            logits, aux = jax.jit(lambda p, t: T.forward(tcfg, p, t))(tp, tokens)
            out[f"logits/{tag}"], out[f"lm_aux/{tag}"] = np.asarray(logits), np.asarray(aux)
    # The LM step's oracle: the dense loss averaged over the data shards
    # (the EP loss is the per-shard MoE's, and JAX's EP train step under a
    # mesh raises), its gradients and one AdamW update.
    dense = lm_config(T.TransformerConfig, MoeConfig, unroll=True)
    opt_cfg = adamw.AdamWConfig(**OPT)
    for data in sorted({d for d, _ in ''' + repr(MESHES) + '''}):
        def avg_loss(p, data=data):
            parts = [T.loss_fn(dense, p, {"tokens": t, "labels": l})
                     for t, l in zip(jnp.split(tokens, data), jnp.split(labels, data))]
            return sum(parts) / data

        loss_v, grads = jax.jit(jax.value_and_grad(avg_loss))(tp)
        new_p, _, om = adamw.update(tp, grads, adamw.init(tp), opt_cfg)
        out[f"lm_loss/{data}"], out[f"lm_gnorm/{data}"] = np.asarray(loss_v), np.asarray(om["grad_norm"])
        put(f"lm_g/{data}/", grads)
        put(f"lm_new/{data}/", new_p)
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


    def moe_tree(arrays, name):
        """One MoE case's JAX parameters and their EP specs."""
        p = {k: torch.as_tensor(v) for k, v in tree(arrays, f"moe_{name}/").items()
             if not isinstance(v, dict)}
        specs = {"router": (), "w_gate": ("model", None, None), "w_up": ("model", None, None),
                 "w_down": ("model", None, None)}
        if "shared" in tree(arrays, f"moe_{name}/"):
            p["shared"] = {k: torch.as_tensor(v) for k, v in tree(arrays, f"moe_{name}/shared/").items()}
            specs["shared"] = {"w_gate": (None, "model"), "w_up": (None, "model"), "w_down": ("model", None)}
        return p, specs


    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = v.detach()
        return out


    def rank_main(rank, world, store_path, out_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        try:
            from repro_torch.configs import base
            from repro_torch.convert import transformer_params_from_arrays
            from repro_torch.distributed.sharding import gather_tree, lm_batch_spec, lm_param_specs, shard_tree
            from repro_torch.launch.mesh import make_host_mesh, sum_replicated
            from repro_torch.models import transformer as T
            from repro_torch.models.moe import MoeConfig, moe_fwd_ep
            from repro_torch.optim import adamw
            from repro_torch.optim.adamw import leaves, tree_unflatten

            arrays = dict(np.load(os.path.join(out_dir, "jax.npz")))
            x = torch.as_tensor(arrays["x"])
            w = torch.as_tensor(arrays["w"])
            tokens = torch.as_tensor(arrays["tokens"])
            labels = torch.as_tensor(arrays["labels"])
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
                        p, specs = moe_tree(arrays, name)
                        y, aux = moe_fwd_ep(shard_tree(p, specs, mesh), x_loc, cfg, mesh)
                        saved[f"y/{name}/{tag}"] = torch.cat(mesh.all_gather(y, axis="data")).numpy()
                        saved[f"aux/{name}/{tag}"] = aux.numpy()
                        saved[f"e_loc/{name}/{tag}"] = np.asarray(shard_tree(p, specs, mesh)["w_gate"].shape[0])
                    pspecs = lm_param_specs(lm)
                    placed = shard_tree(lm, pspecs, mesh)
                    tok_loc = shard_tree({"t": tokens}, {"t": lm_batch_spec(mesh)}, mesh)["t"]
                    logits, aux = T.forward(tcfg, placed, tok_loc, mesh=mesh)
                    logits = torch.cat(mesh.all_gather(logits, axis="model"), dim=-1)  # vocabulary columns
                    saved[f"logits/{tag}"] = torch.cat(mesh.all_gather(logits, axis="data")).numpy()
                    saved[f"lm_aux/{tag}"] = aux.numpy()
                # The backward: every rank holds the global loss; the leaves'
                # gradients are summed over the data axis, x's is its shard's.
                w_loc = shard_tree({"w": w}, {"w": ("data", None, None)}, mesh)["w"]
                for name, cfg in moe_configs(MoeConfig).items():
                    p, specs = moe_tree(arrays, name)
                    live = {k: ({kk: vv.requires_grad_(True) for kk, vv in v.items()} if isinstance(v, dict)
                                else v.requires_grad_(True)) for k, v in shard_tree(p, specs, mesh).items()}
                    xl = x_loc.clone().requires_grad_(True)
                    y, aux = moe_fwd_ep(live, xl, cfg, mesh)
                    loss = sum_replicated((y * w_loc).sum(), mesh, "data") + aux
                    ws = list(leaves(live))
                    gx, *gs = torch.autograd.grad(loss, [xl, *ws])
                    g = gather_tree(tree_unflatten(live, [mesh.all_reduce(t, axis="data") for t in gs]), specs, mesh)
                    for key, t in flat(g).items():
                        saved[f"g/{name}/{tag}/{key}"] = t.numpy()
                    saved[f"g/{name}/{tag}/x"] = torch.cat(mesh.all_gather(gx, axis="data")).numpy()
                    (ga,) = torch.autograd.grad(moe_fwd_ep(live, x_loc, cfg, mesh)[1], [live["router"]])
                    saved[f"g_aux/{name}/{tag}"] = mesh.all_reduce(ga, axis="data").numpy()
                lab_loc = shard_tree({"t": labels}, {"t": lm_batch_spec(mesh)}, mesh)["t"]
                batch = {"tokens": tok_loc, "labels": lab_loc}
                loss, grads = base.value_and_grad(lambda q: T.loss_fn(tcfg, q, batch, mesh=mesh), placed, mesh)
                for key, t in flat(gather_tree(grads, pspecs, mesh)).items():
                    saved[f"lm_g/{tag}/{key}"] = t.numpy()
                saved[f"lm_loss/{tag}"] = loss.numpy()
                gnorm = base.grad_norm(grads, mesh, pspecs)  # None where no leaf is split
                saved[f"lm_gnorm/{tag}"] = (adamw.global_norm(grads) if gnorm is None else gnorm).numpy()
                step = base.train_step_fn(lambda q, b: T.loss_fn(tcfg, q, b, mesh=mesh), mesh,
                                          adamw.AdamWConfig(**OPT), specs_of=lm_param_specs)
                new_p, _, loss2 = step(placed, adamw.init(placed), batch)
                for key, t in flat(gather_tree(new_p, pspecs, mesh)).items():
                    saved[f"lm_new/{tag}/{key}"] = t.numpy()
                saved[f"lm_step_loss/{tag}"] = loss2.numpy()
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


def _bar(want) -> float:
    """The backward's bar: 1e-5 of the leaf's largest entry, at least 1e-5."""
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def _assert_within_bar(got, want, keys):
    for key in keys:
        assert got[key].shape == want[key].shape, key
        gap = float(np.abs(got[key].astype(np.float64) - want[key]).max())
        assert gap <= _bar(want[key]), f"{key}: max |Δ| {gap:.3g} > {_bar(want[key]):.3g}"


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", CASES)
def test_moe_fwd_ep_gradients_equal_jax(runs, case, shape):
    """x and every leaf (the expert shards gathered over the model axis)."""
    want, got = runs
    prefix = f"g/{case}/{_tag(shape)}/"
    keys = sorted(k for k in want if k.startswith(prefix))
    assert sorted(k for k in got if k.startswith(prefix)) == keys
    assert {prefix + k for k in ("x", "router", "w_gate", "w_up", "w_down")} <= set(keys)
    assert (prefix + "shared/w_up" in keys) == (case == "shared")
    _assert_within_bar(got, want, keys)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", CASES)
def test_aux_only_router_gradient_counted_once(runs, case, shape):
    """An aux-only loss's router gradient: a sum over the model axis as well
    would multiply it by the model ranks."""
    want, got = runs
    key = f"g_aux/{case}/{_tag(shape)}"
    assert np.abs(want[key]).max() > 1e-6
    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_lm_step_equals_the_dense_jax_step_per_shard(runs, shape):
    """The two-layer MoE LM on the mesh: its loss, every gradient (gathered)
    and one AdamW update against the JAX dense loss averaged over the data
    shards; the clipping's global norm too."""
    want, got = runs
    tag, data = _tag(shape), shape[0]
    for name in ("lm_loss", "lm_gnorm"):
        gap = abs(float(got[f"{name}/{tag}"]) - float(want[f"{name}/{data}"]))
        assert gap <= _bar(want[f"{name}/{data}"]), name
    assert float(got[f"lm_step_loss/{tag}"]) == float(got[f"lm_loss/{tag}"])
    for kind in ("lm_g", "lm_new"):
        keys = sorted(k[len(f"{kind}/{data}/"):] for k in want if k.startswith(f"{kind}/{data}/"))
        assert sorted(k[len(f"{kind}/{tag}/"):] for k in got if k.startswith(f"{kind}/{tag}/")) == keys
        assert "layers/moe/w_gate" in keys and "layers/attn/wq" in keys
        _assert_within_bar({k: got[f"{kind}/{tag}/{k}"] for k in keys},
                           {k: want[f"{kind}/{data}/{k}"] for k in keys}, keys)


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
    from repro_torch.distributed.sharding import lm_param_specs, shard_tree
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import MoeConfig

    ns = {}
    exec(_CONFIGS, ns)
    cfg = ns["lm_config"](T.TransformerConfig, MoeConfig)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, 128, (2, 8), generator=torch.Generator().manual_seed(1))
    placed = shard_tree(params, lm_param_specs(params), mesh)
    with torch.no_grad():
        logits, aux = T.forward(cfg, placed, tokens, mesh=mesh)
        logits0, aux0 = T.forward(cfg, params, tokens)
    assert torch.equal(logits, logits0) and torch.equal(aux, aux0)
    # A dense config on a mesh runs the JAX layout (tensor parallel), here
    # the meshless forward too.
    dense = dataclasses.replace(cfg, moe=None)
    dense_params = T.init_params(dense, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        got, want = T.forward(dense, dense_params, tokens, mesh=mesh), T.forward(dense, dense_params, tokens)
    assert torch.equal(got[0], want[0])


def _grads(fn, p, x, w):
    """The gradients of ``sum(y · w) + aux`` in x and in ``p``'s leaves."""
    from repro_torch.optim.adamw import leaves, tree_map

    live = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
    xl = x.clone().requires_grad_(True)
    y, aux = fn(live, xl)
    return torch.autograd.grad((y * w).sum() + aux, [xl, *leaves(live)])


@pytest.mark.parametrize("case", CASES)
def test_one_by_one_mesh_gradients_are_moe_fwd_bit_for_bit(mesh, case):
    """On a (1, 1) mesh the EP backward is ``moe_fwd``'s, bit for bit: x and
    every leaf (the collectives over a group of one are identities)."""
    from repro_torch.models.moe import MoeConfig, moe_fwd, moe_fwd_ep, moe_init

    ns = {}
    exec(_CONFIGS, ns)
    cfg = ns["moe_configs"](MoeConfig)[case]
    p = moe_init(torch.Generator().manual_seed(0), 32, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x, w = torch.randn(4, 32, 32, generator=gen), torch.randn(4, 32, 32, generator=gen)
    ep = _grads(lambda q, xx: moe_fwd_ep(q, xx, cfg, mesh), p, x, w)
    dense = _grads(lambda q, xx: moe_fwd(q, xx, cfg), p, x, w)
    assert len(ep) == len(dense) == 5 + 3 * (case == "shared")
    assert all(torch.equal(a, b) for a, b in zip(ep, dense))
    assert all(bool(g.abs().max() > 0) for g in ep)


def test_one_by_one_transformer_ep_step_is_dense_bit_for_bit(mesh):
    """The MoE LM's loss, gradients and train step with the (1, 1) mesh equal
    the meshless ones bit for bit."""
    from repro_torch.configs import base
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import MoeConfig
    from repro_torch.optim import adamw

    ns = {}
    exec(_CONFIGS, ns)
    cfg = ns["lm_config"](T.TransformerConfig, MoeConfig)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 128, (2, 8), generator=gen),
             "labels": torch.randint(0, 128, (2, 8), generator=gen)}
    loss, grads = base.value_and_grad(lambda p: T.loss_fn(cfg, p, batch, mesh=mesh), params, mesh)
    loss0, grads0 = base.value_and_grad(lambda p: T.loss_fn(cfg, p, batch), params)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(adamw.leaves(grads), adamw.leaves(grads0)))
    state = adamw.init(params)
    new = base.lm_train_step(cfg, mesh)(params, state, batch)
    new0 = base.lm_train_step(cfg)(params, state, batch)
    assert all(torch.equal(a, b) for a, b in zip(adamw.leaves(new[0]), adamw.leaves(new0[0])))
    assert not torch.equal(new[0]["layers"]["moe"]["w_up"], params["layers"]["moe"]["w_up"])
