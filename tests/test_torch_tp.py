"""The port's LM in the JAX layout (``transformer.forward``/``loss_fn``/
``serve_step`` with a mesh): vocabulary-parallel embedding and
cross-entropy, tensor-parallel attention and SwiGLU (an MoE's shared expert
too), expert-parallel routed experts and split-K decode, against the JAX
package's own dense functions (the layout changes placement, not the
function), and its remat.

JAX runs in a subprocess on the CPU, without a mesh: each config's
forward, ``loss_fn`` with ``jax.value_and_grad`` and one AdamW update on
the whole batch, and for the MoE on each data shard of it (the loss and
gradients averaged over the shards, as every rank of the port holds the
global loss: the MoE's capacity and aux are per shard), and eight
``serve_step``s on the whole batch. The port runs the meshes (1, 4), (2, 2) and (4, 1) on four
gloo ranks and (1, 2) on two (each rank its data shard of the tokens and
its shard of every leaf by ``lm_param_specs``), and rank 0 writes what it
gathered. The configs: a dense LM whose heads do not divide the model axis
(6 q and 2 kv heads: 1.5 heads a rank at model 4, so q is gathered), one
whose rank's heads straddle two kv groups at model 4 (6 q and 3 kv heads:
kv repeated for the rank's heads), one whose heads divide (4 q, 2 kv), and
an MoE with a shared expert. Held:

* logits within 1e-5;
* the loss and every gradient (gathered by ``gather_tree``) within
  ``1e-5 · max(1, max |g|)`` of ``jax.value_and_grad(loss_fn)``, and the
  clipping norm over the shards equal to the whole norm within that bar;
* one AdamW update within the same bar;
* eight decode steps' logits within 1e-5 of the JAX ``serve_step`` (the
  cache's 16 positions split over the model axis, so at model 4 two ranks
  own no written position), and every rank's cache slice within 1e-5 of
  the JAX cache's, the unwritten positions zero;
* remat's loss and gradients bit-equal to no remat, on every mesh;
* on one rank, the (1, 1) mesh bit-equal to no mesh (forward, loss,
  gradients, the train step, decode);
* the dry run's LM cells on both production meshes with
  ``bytes_per_device_as_run == bytes_per_device``, and the new collectives
  counted on ``meta``.
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
MESHES = ((1, 2), (1, 4), (2, 2), (4, 1))
CASES = ("split", "straddle", "whole", "moe")
torch.set_num_threads(1)

# The configs, written once for both packages (the port's have the same fields).
_CONFIGS = textwrap.dedent('''
    # One AdamW step (eps 1e-3, as tests/test_torch_moe_ep.py sets it: at 1e-8
    # a gradient entry within rounding of zero moves its leaf by lr · Δg / eps).
    OPT = dict(lr=1e-2, warmup_steps=1, eps=1e-3)
    BATCH, SEQ, TMAX, DECODE_STEPS = 4, 8, 16, 8


    def configs(TransformerConfig, MoeConfig, **kw):
        return {
            "split": TransformerConfig(n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, d_ff=64, vocab=128, **kw),
            "straddle": TransformerConfig(n_layers=2, d_model=48, n_heads=6, n_kv_heads=3, d_ff=64, vocab=128,
                                          **kw),
            "whole": TransformerConfig(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128, **kw),
            "moe": TransformerConfig(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
                                     moe=MoeConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1), **kw),
        }
''')

_JAX = _CONFIGS + textwrap.dedent('''
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as T
    from repro.models.moe import MoeConfig
    from repro.optim import adamw

    out = {}

    def put(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(f"{prefix}{k}/", v)
            else:
                out[prefix + k] = np.asarray(v)

    tokens = jax.random.randint(jax.random.PRNGKey(3), (BATCH, SEQ), 0, 128)
    labels = jax.random.randint(jax.random.PRNGKey(5), (BATCH, SEQ), 0, 128)
    out["tokens"], out["labels"] = np.asarray(tokens), np.asarray(labels)
    opt_cfg = adamw.AdamWConfig(**OPT)
    for i, (case, cfg) in enumerate(configs(T.TransformerConfig, MoeConfig).items()):
        params = T.init_params(cfg, jax.random.PRNGKey(20 + i))
        put(f"{case}/params/", params)
        fwd = jax.jit(lambda p, t, cfg=cfg: T.forward(cfg, p, t)[0])
        vg = jax.jit(jax.value_and_grad(lambda p, t, l, cfg=cfg: T.loss_fn(cfg, p, {"tokens": t, "labels": l})))
        # A dense LM's function does not depend on the data split (the shards
        # are equal, the mask all ones); an MoE's does (capacity, aux).
        for data in (1, 2, 4) if cfg.moe else (1,):
            tok_s, lab_s = jnp.split(tokens, data), jnp.split(labels, data)
            out[f"{case}/logits/{data}"] = np.concatenate([np.asarray(fwd(params, t)) for t in tok_s])
            per = [vg(params, t, l) for t, l in zip(tok_s, lab_s)]
            loss = sum(l for l, _ in per) / data
            grads = jax.tree.map(lambda *g: sum(g) / data, *[g for _, g in per])
            new_p, _, om = adamw.update(params, grads, adamw.init(params), opt_cfg)
            out[f"{case}/loss/{data}"], out[f"{case}/gnorm/{data}"] = np.asarray(loss), np.asarray(om["grad_norm"])
            put(f"{case}/grads/{data}/", grads)
            put(f"{case}/new/{data}/", new_p)
        cache = T.init_kv_cache(cfg, BATCH, TMAX)
        step = jax.jit(lambda p, tok, c, pos, cfg=cfg: T.serve_step(cfg, p, tok, c, pos))
        for t in range(DECODE_STEPS):
            lg, cache = step(params, tokens[:, t], cache, jnp.int32(t))
            out[f"{case}/decode/{t}"] = np.asarray(lg)
        out[f"{case}/cache_k"], out[f"{case}/cache_v"] = np.asarray(cache[0]), np.asarray(cache[1])
    np.savez(sys.argv[1], **out)
''')

_PORT = _CONFIGS + textwrap.dedent('''
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
            from repro_torch.distributed.sharding import (gather_tree, kv_cache_spec, lm_batch_spec,
                                                          lm_param_specs, shard_tree)
            from repro_torch.launch.mesh import make_host_mesh
            from repro_torch.models import transformer as T
            from repro_torch.models.moe import MoeConfig
            from repro_torch.optim import adamw

            arrays = dict(np.load(os.path.join(out_dir, "jax.npz")))
            tokens, labels = torch.as_tensor(arrays["tokens"]), torch.as_tensor(arrays["labels"])
            saved = {}

            def whole(t, mesh):  # logits: the rank's vocabulary columns and data shard → all of them
                return torch.cat(mesh.all_gather(torch.cat(mesh.all_gather(t, axis="model"), dim=-1),
                                                 axis="data"))

            for model in {4: (4, 2, 1), 2: (2,)}[world]:
                mesh = make_host_mesh(model=model, device="cpu")
                tag = f"{world // model}x{model}"
                tok = shard_tree({"t": tokens}, {"t": lm_batch_spec(mesh)}, mesh)["t"]
                lab = shard_tree({"t": labels}, {"t": lm_batch_spec(mesh)}, mesh)["t"]
                batch = {"tokens": tok, "labels": lab}
                for case, cfg in configs(T.TransformerConfig, MoeConfig).items():
                    key = f"{case}/{tag}"
                    params = transformer_params_from_arrays(tree(arrays, f"{case}/params/"), device="cpu")
                    specs = lm_param_specs(params)
                    placed = shard_tree(params, specs, mesh)
                    with torch.no_grad():
                        logits, _ = T.forward(cfg, placed, tok, mesh=mesh)
                    saved[f"logits/{key}"] = whole(logits, mesh).numpy()
                    saved[f"local_vocab/{key}"] = np.asarray(logits.shape[-1])

                    loss, grads = base.value_and_grad(lambda q: T.loss_fn(cfg, q, batch, mesh=mesh), placed, mesh)
                    saved[f"loss/{key}"] = loss.numpy()
                    for k, t in flat(gather_tree(grads, specs, mesh)).items():
                        saved[f"grads/{key}/{k}"] = t.numpy()
                    gnorm = base.grad_norm(grads, mesh, specs)
                    saved[f"gnorm/{key}"] = (adamw.global_norm(grads) if gnorm is None else gnorm).numpy()
                    rcfg = dataclasses.replace(cfg, remat=True)
                    loss_r, grads_r = base.value_and_grad(lambda q: T.loss_fn(rcfg, q, batch, mesh=mesh), placed,
                                                          mesh)
                    saved[f"remat_equal/{key}"] = np.asarray(torch.equal(loss_r, loss) and all(
                        torch.equal(a, b) for a, b in zip(adamw.leaves(grads_r), adamw.leaves(grads))))

                    step = base.lm_train_step(cfg, mesh, adamw.AdamWConfig(**OPT))
                    new_p, _, loss2 = step(placed, adamw.init(placed), batch)
                    saved[f"step_loss/{key}"] = loss2.numpy()
                    for k, t in flat(gather_tree(new_p, specs, mesh)).items():
                        saved[f"new/{key}/{k}"] = t.numpy()

                    cspec = kv_cache_spec(mesh)
                    cache = tuple(shard_tree({"c": c}, {"c": cspec}, mesh)["c"]
                                  for c in T.init_kv_cache(cfg, BATCH, TMAX, device="cpu"))
                    saved[f"cache_local_len/{key}"] = np.asarray(cache[0].shape[2])
                    with torch.no_grad():
                        for t in range(DECODE_STEPS):
                            lg, cache = T.serve_step(cfg, placed, tok[:, t], cache, t, mesh=mesh)
                            saved[f"decode/{key}/{t}"] = whole(lg, mesh).numpy()
                    back = gather_tree({"k": cache[0], "v": cache[1]}, {"k": cspec, "v": cspec}, mesh)
                    saved[f"cache_k/{key}"], saved[f"cache_v/{key}"] = back["k"].numpy(), back["v"].numpy()
            if rank == 0:
                np.savez(os.path.join(out_dir, f"port{world}.npz"), **saved)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        world, out_dir = int(sys.argv[1]), sys.argv[2]
        mp.spawn(rank_main, args=(world, os.path.join(out_dir, f"store{world}"), out_dir), nprocs=world)
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
    """JAX's outputs (and inputs), and the port's on two and four ranks."""
    tmp = tmp_path_factory.mktemp("tp")
    _run(_JAX, tmp, str(tmp / "jax.npz"), JAX_PLATFORMS="cpu")
    _run(_PORT, tmp, "4", str(tmp))
    _run(_PORT, tmp, "2", str(tmp))
    got = dict(np.load(tmp / "port4.npz"))
    got.update(np.load(tmp / "port2.npz"))
    return dict(np.load(tmp / "jax.npz")), got


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _bar(want) -> float:
    """The gradient's bar: 1e-5 of the leaf's largest entry, at least 1e-5."""
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def _assert_within_bar(got, want, keys):
    for key in keys:
        assert got[key].shape == want[key].shape, key
        gap = float(np.abs(got[key].astype(np.float64) - want[key]).max())
        assert gap <= _bar(want[key]), f"{key}: max |Δ| {gap:.3g} > {_bar(want[key]):.3g}"


def _leaves(arrays, prefix):
    return sorted(k[len(prefix):] for k in arrays if k.startswith(prefix))


def _split(case, shape) -> int:
    """The data split of the JAX oracle a mesh is held to: the MoE's is the
    mesh's data shards, a dense LM's the whole batch."""
    return shape[0] if case == "moe" else 1


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", CASES)
def test_forward_logits_equal_jax(runs, case, shape):
    """Every rank's vocabulary columns of its data shard's logits, gathered."""
    want, got = runs
    key = f"{case}/{_tag(shape)}"
    assert got[f"local_vocab/{key}"] == 128 // shape[1]
    np.testing.assert_allclose(got[f"logits/{key}"], want[f"{case}/logits/{_split(case, shape)}"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_equal_jax(runs, case, shape):
    """The loss, the clipping norm over the shards and every leaf's gradient
    (gathered over the model axis) against ``jax.value_and_grad``."""
    want, got = runs
    key, data = f"{case}/{_tag(shape)}", _split(case, shape)
    for name in ("loss", "gnorm"):
        gap = abs(float(got[f"{name}/{key}"]) - float(want[f"{case}/{name}/{data}"]))
        assert gap <= _bar(want[f"{case}/{name}/{data}"]), name
    keys = _leaves(want, f"{case}/grads/{data}/")
    assert _leaves(got, f"grads/{key}/") == keys
    assert {"embed", "lm_head", "layers/attn/wq", "layers/attn/wo", "layers/ln1/scale"} <= set(keys)
    assert ("layers/moe/shared/w_down" in keys) == (case == "moe") != ("layers/ffn/w_gate" in keys)
    _assert_within_bar({k: got[f"grads/{key}/{k}"] for k in keys},
                       {k: want[f"{case}/grads/{data}/{k}"] for k in keys}, keys)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", CASES)
def test_adamw_update_equals_jax(runs, case, shape):
    """One step of ``lm_train_step`` on the mesh: its loss is the loss, and
    every parameter after the update (gathered) against the JAX update."""
    want, got = runs
    key, data = f"{case}/{_tag(shape)}", _split(case, shape)
    assert float(got[f"step_loss/{key}"]) == float(got[f"loss/{key}"])
    keys = _leaves(want, f"{case}/new/{data}/")
    assert _leaves(got, f"new/{key}/") == keys
    _assert_within_bar({k: got[f"new/{key}/{k}"] for k in keys},
                       {k: want[f"{case}/new/{data}/{k}"] for k in keys}, keys)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", CASES)
def test_split_k_decode_equals_jax_serve_step(runs, case, shape):
    """Eight decode steps' logits, and each rank's cache slice (its data
    shard's sequences, its model rank's positions) against the JAX cache."""
    want, got = runs
    key = f"{case}/{_tag(shape)}"
    assert got[f"cache_local_len/{key}"] == 16 // shape[1]
    for t in range(8):
        np.testing.assert_allclose(got[f"decode/{key}/{t}"], want[f"{case}/decode/{t}"], rtol=0, atol=1e-5)
    for kv in ("cache_k", "cache_v"):
        np.testing.assert_allclose(got[f"{kv}/{key}"], want[f"{case}/{kv}"], rtol=0, atol=1e-5)
        assert not got[f"{kv}/{key}"][:, :, 8:].any()


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", CASES)
def test_remat_gradients_are_bit_equal_on_the_mesh(runs, case, shape):
    want, got = runs
    assert bool(got[f"remat_equal/{case}/{_tag(shape)}"])


# ---------------------------------------------------------------------------
# One rank, in-process
# ---------------------------------------------------------------------------
def _config(case, **kw):
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import MoeConfig

    ns = {}
    exec(_CONFIGS, ns)
    return ns["configs"](T.TransformerConfig, MoeConfig, **kw)[case]


def test_heads_a_rank_reads():
    """``tp_heads`` and ``kv_for_heads``: yi-34b's 3.5 q heads a rank at 16
    (4 heads touched, one kv group), granite's 2 whole heads, and 6 q over
    3 kv heads at 4 ranks, where rank 1's heads 1 and 2 straddle groups 0
    and 1 and the kv heads are repeated."""
    from repro_torch.models.layers import kv_for_heads, tp_heads

    assert [tp_heads(56, 128, 16, r) for r in (0, 1, 2)] == [(0, 448, 0, 4), (448, 896, 3, 7), (896, 1344, 7, 11)]
    assert tp_heads(32, 128, 16, 5) == (1280, 1536, 10, 12)
    k = torch.arange(3.0).reshape(1, 1, 3, 1).expand(1, 1, 3, 1)
    assert kv_for_heads(k, 1, 3, 6)[0, 0, :, 0].tolist() == [0.0, 1.0]      # straddles: one kv head a q head
    assert kv_for_heads(k, 0, 2, 6)[0, 0, :, 0].tolist() == [0.0]           # one group
    assert kv_for_heads(k, 2, 6, 6)[0, 0, :, 0].tolist() == [1.0, 2.0]      # whole groups
    k8 = torch.arange(8.0).reshape(1, 1, 8, 1)
    assert kv_for_heads(k8, 3, 7, 56)[0, 0, :, 0].tolist() == [0.0]         # yi-34b rank 1: group 0


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
def test_one_by_one_mesh_is_meshless_bit_for_bit(mesh, case):
    """Forward, loss, every gradient, one train step and eight decode steps
    on the (1, 1) mesh equal the meshless ones bit for bit (the collectives
    over a group of one are identities)."""
    from repro_torch.configs import base
    from repro_torch.distributed.sharding import lm_param_specs, shard_tree
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    cfg = _config(case)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    placed = shard_tree(params, lm_param_specs(params), mesh)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 128, (2, 8), generator=gen),
             "labels": torch.randint(0, 128, (2, 8), generator=gen)}
    with torch.no_grad():
        got, want = T.forward(cfg, placed, batch["tokens"], mesh=mesh), T.forward(cfg, params, batch["tokens"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    loss, grads = base.value_and_grad(lambda p: T.loss_fn(cfg, p, batch, mesh=mesh), placed, mesh)
    loss0, grads0 = base.value_and_grad(lambda p: T.loss_fn(cfg, p, batch), params)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(adamw.leaves(grads), adamw.leaves(grads0)))
    state = adamw.init(params)
    new, new0 = base.lm_train_step(cfg, mesh)(placed, state, batch), base.lm_train_step(cfg)(params, state, batch)
    assert all(torch.equal(a, b) for a, b in zip(adamw.leaves(new[0]), adamw.leaves(new0[0])))
    caches = [T.init_kv_cache(cfg, 2, 16, device="cpu") for _ in range(2)]
    with torch.no_grad():
        for t in range(8):
            lg, _ = T.serve_step(cfg, placed, batch["tokens"][:, t], caches[0], t, mesh=mesh)
            lg0, _ = T.serve_step(cfg, params, batch["tokens"][:, t], caches[1], t)
            assert torch.equal(lg, lg0)
    assert all(torch.equal(a, b) for a, b in zip(*caches))


@pytest.mark.parametrize("case", CASES)
def test_remat_recomputes_and_its_gradients_are_bit_equal(case, monkeypatch):
    """With ``remat`` the backward runs each layer's attention again (the
    policy saves only the weight products) and the loss and every gradient
    equal the forward without remat, bit for bit; a forward without
    autograd recording runs no checkpoint."""
    from repro_torch.configs import base
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    calls = []
    plain = ops.attention_ref
    monkeypatch.setattr(ops, "attention_ref", lambda *a, **k: calls.append(1) or plain(*a, **k))
    cfg = _config(case)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 128, (2, 8), generator=gen),
             "labels": torch.randint(0, 128, (2, 8), generator=gen)}
    runs = {}
    for remat in (False, True):
        calls.clear()
        c = dataclasses.replace(cfg, remat=remat)
        runs[remat] = base.value_and_grad(lambda p: T.loss_fn(c, p, batch), params)
        assert len(calls) == cfg.n_layers * (2 if remat else 1)
    (loss0, g0), (loss1, g1) = runs[False], runs[True]
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(adamw.leaves(g0), adamw.leaves(g1)))
    calls.clear()
    with torch.no_grad():
        T.forward(dataclasses.replace(cfg, remat=True), params, batch["tokens"])
    assert len(calls) == cfg.n_layers


def test_full_configs_set_remat_where_jax_does():
    for module in ("granite_3_8b", "yi_34b", "deepseek_coder_33b", "deepseek_moe_16b", "qwen3_moe_30b_a3b"):
        port = __import__(f"repro_torch.configs.{module}", fromlist=["FULL"]).FULL
        jax_cfg = __import__(f"repro.configs.{module}", fromlist=["FULL"]).FULL
        assert port.remat is jax_cfg.remat is True, module


# ---------------------------------------------------------------------------
# The dry run on meta
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True], ids=("16x16", "2x16x16"))
def test_every_lm_cell_runs_the_jax_layout(multi_pod):
    """Every runnable LM cell's bytes as run equal the JAX layout's (the
    specs the step runs under are the cell's ``in_specs``); yi-34b's
    ``train_4k`` holds 21.50 GB a device."""
    from repro_torch.configs import all_cells, get
    from repro_torch.launch.dryrun import _per_device_bytes
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod)
    cells = [(a, s) for a, s in all_cells() if get(a).family == "lm"]
    assert len(cells) == 15
    for arch, shape in cells:
        spec = get(arch).dryrun(shape, mesh)
        assert spec.run_specs is None, (arch, shape)
        assert _per_device_bytes(spec, mesh, as_run=True) == _per_device_bytes(spec, mesh, as_run=False)
    yi = _per_device_bytes(get("yi-34b").dryrun("train_4k", mesh), mesh, as_run=True)
    assert round(sum(yi.values()) / 1e9, 2) == 21.50


def test_din_cells_run_their_tables_whole():
    """DIN's lookup is not vocabulary parallel: its cells run the tables
    whole along the model axis, so its bytes as run exceed the layout's."""
    from repro_torch.configs import get
    from repro_torch.launch.dryrun import _per_device_bytes
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    for shape in ("train_batch", "serve_p99", "retrieval_cand"):
        spec = get("din").dryrun(shape, mesh)
        run, layout = _per_device_bytes(spec, mesh, as_run=True), _per_device_bytes(spec, mesh, as_run=False)
        assert run["params"] > layout["params"] and run["batch"] == layout["batch"]


def test_meta_mesh_counts_gathers_and_scatters():
    from repro_torch.launch.mesh import MetaMesh, gather_last

    mesh = MetaMesh({"data": 16, "model": 16})
    t = torch.empty(4, 6, device="meta", dtype=torch.bfloat16, requires_grad=True)
    parts = mesh.all_gather(t, axis="model")
    assert len(parts) == 16 and parts[0].shape == (4, 6)
    assert mesh.reduce_scatter(torch.empty(32, 6, device="meta"), axis="model").shape == (2, 6)
    whole = gather_last(t, mesh, "model")
    assert whole.shape == (4, 96)
    (g,) = torch.autograd.grad(whole.float().sum(), [t])
    assert g.shape == (4, 6)
    stats = mesh.collective_stats()
    assert stats["all-gather"] == {"count": 2, "bytes": 2 * 16 * 4 * 6 * 2}
    assert stats["reduce-scatter"] == {"count": 2, "bytes": 2 * 6 * 4 + 4 * 6 * 2}
    one = MetaMesh({"data": 1, "model": 1})
    assert len(one.all_gather(t, axis="model")) == 1 and one.collective_stats()["total_count"] == 0


def test_lm_train_cell_counts_the_tensor_parallel_collectives():
    """granite-3-8b's ``train_4k`` on the single mesh: rank 0's forward
    gathers k and v and reduces the attention and FFN outputs over the
    model axis; the backward reduce-scatters the gathers, and remat (set in
    the config, as in the JAX one) gathers them again when it recomputes a
    layer."""
    from repro_torch.configs import get
    from repro_torch.configs.base import rank_args
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    spec = get("granite-3-8b").dryrun("train_4k", mesh)
    params, opt, batch = rank_args(spec, mesh)
    assert params["layers"]["attn"]["wk"].shape == (40, 4096, 64) and batch["tokens"].shape == (16, 4096)
    spec.step_fn(params, opt, batch)
    stats = mesh.collective_stats()
    assert stats["all-gather"]["count"] == 2 * 2 * 40 and stats["reduce-scatter"]["count"] == 2 * 40
    assert stats["all-gather"]["bytes"] == 2 * 2 * 40 * 16 * 4096 * 1024 * 2
