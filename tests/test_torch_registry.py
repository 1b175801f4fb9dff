"""The port's config registry and dry run (``repro_torch.configs``,
``repro_torch.launch.dryrun``) against the JAX package's.

JAX runs in a subprocess with 512 forced CPU devices, as its dry run does
(``src/repro/launch/dryrun.py:1-2``): it builds every runnable cell's spec
on both production meshes and lowers nothing, then writes the archs, cells,
skips, each arch's family, shapes and meta, each cell's kind, every
``abstract_args`` leaf's shape and dtype and every ``in_specs`` leaf (a
``PartitionSpec`` read as a tuple), ``analytic_model_flops`` at 256 and 512
devices and ``_gnn_shape_dims``; beside it, one subprocess an LM arch runs
the JAX smoke and writes its metrics, initial parameters and tokens. The
port's smokes run on the CPU (the LM smokes also on the JAX smoke's
parameters, within 1e-5 of its loss and gradient norm), one dry-run cell
per family runs on ``meta`` through the CLI, and the two kernels the dry
run reaches take ``meta`` tensors to their plain versions, forward and
backward.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import all_archs, all_cells

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")
LM_ARCHS = ("deepseek-coder-33b", "deepseek-moe-16b", "granite-3-8b", "qwen3-moe-30b-a3b", "yi-34b")
SMOKE_ATOL = 1e-5

_JAX = textwrap.dedent('''
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import numpy as np
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import all_archs, all_cells, get, skipped_cells
    from repro.configs import base
    from repro.launch.mesh import make_production_mesh


    def key_str(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


    def entry(e):
        return None if e is None else e if isinstance(e, str) else list(e)


    out = {"archs": all_archs(), "cells": all_cells(), "skipped": skipped_cells(), "arch": {},
           "specs": {}, "flops": {}, "gnn_dims": {s: base._gnn_shape_dims(s) for s in base.GNN_SHAPES}}
    for a in all_archs():
        c = get(a)
        out["arch"][a] = {"family": c.family, "shapes": list(c.shapes), "meta": c.meta}
    for name, multi in (("single", False), ("multi", True)):
        mesh = make_production_mesh(multi_pod=multi)
        for a, s in all_cells():
            spec = get(a).dryrun(s, mesh)
            args, _ = jax.tree_util.tree_flatten_with_path(spec.abstract_args)
            specs, _ = jax.tree_util.tree_flatten_with_path(spec.in_specs, is_leaf=lambda x: isinstance(x, P))
            out["specs"][f"{a}|{s}|{name}"] = {
                "kind": spec.kind,
                "args": {key_str(p): [list(l.shape), str(l.dtype)] for p, l in args},
                "in_specs": {key_str(p): [entry(e) for e in l] for p, l in specs},
            }
    for a, s in all_cells():
        for n in (256, 512):
            out["flops"][f"{a}|{s}|{n}"] = base.analytic_model_flops(a, s, n)

    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
''')

# One LM arch's smoke, with the initial parameters and tokens it draws (a
# process each: eager JAX compiles op by op, ~10-25 s a smoke).
_JAX_SMOKE = textwrap.dedent('''
    import sys, json
    import numpy as np
    import jax
    from repro.configs import get
    from repro.models import transformer as tf

    drawn = {}
    init = tf.init_params

    def recording_init(cfg, key):
        drawn["p"] = init(cfg, key)
        return drawn["p"]

    tf.init_params = recording_init
    metrics = get(sys.argv[1]).smoke()
    leaves, _ = jax.tree_util.tree_flatten_with_path(drawn["p"])
    arrays = {"/".join(str(k.key) for k in p): np.asarray(l) for p, l in leaves}
    arrays["tokens"] = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 211))
    np.savez(sys.argv[3], **arrays)
    with open(sys.argv[2], "w") as f:
        json.dump(metrics, f)
''')


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX registry's description, and each LM smoke's metrics with its
    parameters and tokens: six subprocesses at once."""
    tmp = tmp_path_factory.mktemp("registry")
    (tmp / "registry.py").write_text(_JAX)
    (tmp / "smoke.py").write_text(_JAX_SMOKE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cmds = [[str(tmp / "registry.py"), str(tmp / "ref.json")]]
    cmds += [[str(tmp / "smoke.py"), a, str(tmp / f"{a}.json"), str(tmp / f"{a}.npz")] for a in LM_ARCHS]
    procs = [subprocess.Popen([sys.executable, *c], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for c in cmds]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
    want = json.loads((tmp / "ref.json").read_text())
    smokes = {a: (json.loads((tmp / f"{a}.json").read_text()), dict(np.load(tmp / f"{a}.npz")))
              for a in LM_ARCHS}
    return want, smokes


def _entry(e):
    return None if e is None else e if isinstance(e, str) else list(e)


def _mesh(name):
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=name == "multi")


def test_archs_cells_and_skips_equal_jax(ref):
    from repro_torch.configs import skipped_cells

    want, _ = ref
    assert all_archs() == want["archs"]
    assert [list(c) for c in all_cells()] == want["cells"] and len(all_cells()) == 35
    assert [list(c) for c in skipped_cells()] == want["skipped"]
    assert len(skipped_cells()) == 5 and all(s[1] == "long_500k" for s in skipped_cells())


@pytest.mark.parametrize("arch", all_archs())
def test_arch_family_shapes_and_meta_equal_jax(ref, arch):
    from repro_torch.configs import get

    want, _ = ref
    c = get(arch)
    assert c.arch_id == arch and c.probe is None and c.probe_layers == 0
    assert {"family": c.family, "shapes": list(c.shapes), "meta": c.meta} == want["arch"][arch]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch,shape", all_cells())
def test_cell_spec_equals_jax(ref, arch, shape, mesh_name):
    """Kind, every abstract leaf's shape and dtype (``meta`` tensors), and
    the in-specs leaf by leaf."""
    from repro_torch.configs import get
    from repro_torch.launch.dryrun import leaves_with_specs

    want, _ = ref
    w = want["specs"][f"{arch}|{shape}|{mesh_name}"]
    spec = get(arch).dryrun(shape, _mesh(mesh_name))
    assert spec.kind == w["kind"]
    leaves = [(path.replace(".", "/"), t, s) for path, t, s in leaves_with_specs(spec.abstract_args, spec.in_specs)]
    assert all(t.device.type == "meta" for _, t, _ in leaves)
    assert {k: [list(t.shape), str(t.dtype).replace("torch.", "")] for k, t, _ in leaves} == w["args"]
    assert {k: [_entry(e) for e in s] for k, _, s in leaves} == w["in_specs"]


@pytest.mark.parametrize("arch,shape", [c for c in all_cells() if c[0] not in LM_ARCHS])
def test_analytic_model_flops_equal_jax(ref, arch, shape):
    from repro_torch.configs.base import analytic_model_flops

    want, _ = ref
    for n in (256, 512):
        assert analytic_model_flops(arch, shape, n) == want["flops"][f"{arch}|{shape}|{n}"]


@pytest.mark.parametrize("shape", ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"))
def test_gnn_shape_dims_equal_jax(ref, shape):
    from repro_torch.configs.base import _gnn_shape_dims

    want, _ = ref
    assert json.loads(json.dumps(_gnn_shape_dims(shape))) == want["gnn_dims"][shape]


@pytest.mark.parametrize("arch", all_archs())
def test_smoke_runs_on_the_cpu(arch):
    from repro_torch.configs import get

    metrics = get(arch).smoke(device="cpu")
    assert isinstance(metrics, dict) and metrics
    assert all(np.isfinite(v) for v in metrics.values()), metrics


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_equals_jax_on_its_parameters(ref, arch):
    from repro_torch.configs import get
    from repro_torch.convert import transformer_params_from_arrays

    _, smokes = ref
    want, arrays = smokes[arch]
    tree = {}
    for key, v in arrays.items():
        if key != "tokens":
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    params = transformer_params_from_arrays(tree, device="cpu")
    got = get(arch).smoke(device="cpu", params=params, tokens=torch.as_tensor(arrays["tokens"]))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v) <= SMOKE_ATOL, (k, got[k], v)


@pytest.mark.parametrize("arch,shape", [("deepseek-moe-16b", "train_4k"), ("gcn-cora", "full_graph_sm"),
                                        ("din", "train_batch")], ids=("lm", "gnn", "recsys"))
def test_dryrun_writes_a_line_per_cell(tmp_path, capsys, arch, shape):
    """``python -m repro_torch.launch.dryrun`` for one cell at the single
    mesh: one well-formed line, rank 0's step counted on ``meta``."""
    from repro_torch.launch import dryrun

    out = tmp_path / "dryrun_torch.jsonl"
    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert (r["status"], r["arch"], r["shape"], r["mesh"], r["n_devices"], r["kind"]) == (
        "ok", arch, shape, "16x16", 256, "train")
    assert r["memory_analysis"] is None and "no compiler" in r["memory_analysis_reason"]
    assert set(r["bytes_per_device"]) == {"params", "opt_state", "batch"}
    assert all(r["bytes_per_device_as_run"][k] >= v for k, v in r["bytes_per_device"].items())
    if arch == "deepseek-moe-16b":  # an LM cell runs the JAX layout
        assert r["bytes_per_device_as_run"] == r["bytes_per_device"]
    assert set(r["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                     "collective-permute", "total_bytes", "total_count"}
    assert r["collectives"]["all-reduce"]["count"] > 0  # the gradients, summed over the data axis
    assert r["flops_per_device"] > 0 and r["analytic_flops_per_device"] > 0
    assert r["flops_ratio"] == r["flops_per_device"] / r["analytic_flops_per_device"]
    assert r["output_shapes"]["2"] == [[], "float32"]  # the loss
    if arch == "deepseek-moe-16b":
        # expert parallel: rank 0 holds 64 / 16 experts of each of the 28 layers
        assert r["output_shapes"]["0/layers/moe/w_gate"] == [[28, 4, 2048, 1408], "bfloat16"]
        # tensor parallel: its 2048 / 16 columns of wq
        assert r["output_shapes"]["0/layers/attn/wq"] == [[28, 2048, 128], "bfloat16"]
    assert f"[dryrun] {arch} × {shape} × 16x16: OK" in capsys.readouterr().out


def test_production_mesh():
    from repro_torch.distributed.sharding import batch_axes

    single, multi = _mesh("single"), _mesh("multi")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert batch_axes(single) == ("data",) and batch_axes(multi) == ("pod", "data")
    assert multi.axis_index(("pod", "data")) == 0 and multi.axis_index("model") == 0
    t = torch.empty(4, 6, device="meta", dtype=torch.bfloat16)
    assert multi.all_reduce(t, axis=("pod", "data")).shape == (4, 6)
    assert multi.all_reduce(t, axis="model").device.type == "meta"
    stats = multi.collective_stats()
    assert stats["all-reduce"] == {"count": 2, "bytes": 96}
    assert (stats["total_bytes"], stats["total_count"]) == (96, 2)
    one = type(multi)({"data": 1, "model": 1})
    one.all_reduce(t, axis="model")  # one rank: moves nothing, not counted
    assert one.collective_stats()["total_count"] == 0
    with pytest.raises(ValueError, match="meta tensors"):
        multi.all_reduce(torch.zeros(2), axis="model")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        single.all_reduce(t, axis="pod")


def test_kernels_take_meta_to_their_plain_versions():
    """``flash_attention`` and ``embedding_bag`` on ``meta``: the plain
    versions' shapes forward and backward, no kernel launched."""
    from repro_torch import kernels
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_attention import flash_attention

    kernels.reset_launch_counts()
    q = torch.empty(8, 64, 128, device="meta", dtype=torch.bfloat16, requires_grad=True)
    k = torch.empty(2, 64, 128, device="meta", dtype=torch.bfloat16, requires_grad=True)
    v = torch.empty(2, 64, 128, device="meta", dtype=torch.bfloat16, requires_grad=True)
    out = flash_attention(q, k, v, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), [q, k, v])
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    table = torch.empty(1000, 18, device="meta", requires_grad=True)
    idx = torch.empty(5, 7, device="meta", dtype=torch.int32)
    w = torch.empty(5, 7, device="meta", requires_grad=True)
    pooled = embedding_bag(table, idx, w)
    assert pooled.device.type == "meta" and pooled.shape == (5, 18)
    gt, gw = torch.autograd.grad(pooled.sum(), [table, w])
    assert gt.shape == table.shape and gw.shape == w.shape
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def test_rank_args_cut_the_batch_and_the_experts():
    """Rank 0's arguments of qwen3-moe-30b-a3b's train cell on the single
    mesh: its data shard of the batch, its 8 of 128 experts (and their
    moments), and every other leaf as the JAX layout splits it (vocabulary
    rows of the embedding, columns of wq); the decode cell's cache is its
    data shard's sequences and its 2,048 of 32,768 positions."""
    from repro_torch.configs import get
    from repro_torch.configs.base import rank_args

    mesh = _mesh("single")
    spec = get("qwen3-moe-30b-a3b").dryrun("train_4k", mesh)
    params, opt, batch = rank_args(spec, mesh)
    assert batch["tokens"].shape == (16, 4096)
    assert params["layers"]["moe"]["w_up"].shape == (48, 8, 2048, 768)
    assert opt["v"]["layers"]["moe"]["w_down"].shape == (48, 8, 768, 2048)
    assert spec.abstract_args[0]["embed"].shape == (151_936, 2048)
    assert params["embed"].shape == (151_936 // 16, 2048)
    assert params["layers"]["attn"]["wq"].shape == (48, 2048, 4096 // 16)
    decode = get("qwen3-moe-30b-a3b").dryrun("decode_32k", mesh)
    p_dec, token, (ck, _) = rank_args(decode, mesh)
    assert p_dec["layers"]["moe"]["w_up"].shape == (48, 8, 2048, 768)  # decode runs expert parallel
    assert token.shape == (8,) and ck.shape == (48, 8, 32768 // 16, 4, 128)


def test_registry_is_whole_after_one_config_import():
    """Importing one arch's module first registers that arch alone; the
    registry still loads all ten (the JAX ``_ensure_loaded`` returns once
    any arch is registered, ROADMAP C)."""
    code = ("from repro_torch.configs import din\n"
            "from repro_torch.configs.base import _REGISTRY, all_archs\n"
            "print(len(_REGISTRY), len(all_archs()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["1", "10"]
