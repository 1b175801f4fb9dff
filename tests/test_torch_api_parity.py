"""The port's public API against the JAX package's, by AST.

Every module of ``src/repro/`` has a twin file at the same path under
``src/repro_torch/``. For each pair this test reads both sources (it
imports neither) and fails on any public module-level function or class,
public method (and ``__init__``), parameter of one of them, or command-line
flag (an ``add_argument("--...")``) that the JAX file has and its twin
lacks, unless the name is an allowlisted JAX idiom below, whose twin in the
port takes another form. The allowlist holds only those idioms; an entry no
JAX file uses any more fails too, so the list cannot outlive its reason.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# JAX idioms with no twin of the same name, and their torch form.
IDIOM_PARAMS = {
    "key": "an explicit torch.Generator (or seed) in place of a PRNG key",
    "use_kernel": "dispatch by the tensor's device: a CUDA tensor launches the kernel, a CPU "
                  "tensor runs its plain version",
    "interpret": "the same dispatch by device; a CUDA kernel has no interpret mode",
    "flat_layout": "one attention layout; the GSPMD flat-layout A/B has no torch counterpart",
    "ep_spec": "HostMesh and shard_tree place the experts",
    "data_axes": "HostMesh's data axis and its subgroup",
    "model_axis": "HostMesh's model axis and its subgroup",
    "params_shape": "the specs are built from the parameter tree itself (meta tensors for the "
                    "dry run)",
    "as_numpy": "engines return tensors; callers call .cpu().numpy() where they need host arrays",
    "spill_s": "SpillTail carries the over-cap edges",
    "spill_r": "SpillTail carries the over-cap edges",
    "spill_w": "SpillTail carries the over-cap edges",
    "shared_ids": "each rank passes its own rows",
}
IDIOM_FUNCS = {
    "on_tpu": "dispatch by the tensor's device",
    "resolve_interpret": "dispatch by the tensor's device",
    "attention_ref_bthd": "one attention layout (BTHD flat-layout A/B not ported)",
    "to_shardings": "shard_tree places a tree on a HostMesh",
    "capture_compiles": "the builds hook (repro_torch.builds) counts rebuilt device programs",
    "collective_stats": "MetaMesh counts collective bytes on meta tensors",
}
# Pallas kernel bodies: each is a CUDA C++ source under src/repro_torch/csrc/.
NO_TWIN_FILES = {
    "kernels/bsr_spmm/kernel.py": "csrc/bell_matmul.cu",
    "kernels/embedding_bag/kernel.py": "csrc/embedding_bag.cu",
    "kernels/flash_attention/kernel.py": "csrc/flash_attention.cu",
    "kernels/frontier/kernel.py": "csrc/frontier_gather.cu",
}
# The graph side's options and utilities, which the port must carry by name.
MUST_TWIN = {
    "core/dynamic_runtime.py": ("DynamicExperimentRuntime.__init__(scheduler)",
                                "DynamicExperimentRuntime.last_result"),
    "core/online.py": ("BackgroundMaintenance.__init__(scheduler)", "OnlineServer.run(supervise)"),
    "core/recovery.py": ("run_with_recovery(snapshot_roundtrip)",),
    "launch/replay.py": ("--force-host-devices",),
    "graphs/structure.py": ("Graph.subgraph", "Graph.clustering_stats", "BlockEll.density",
                            "BlockEll.to_dense", "PaddedNeighbors.max_deg"),
    "core/traffic.py": ("TrafficResult.sorted_percent_global",),
}

JAX_FILES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def api(source: str) -> dict:
    """``name -> [parameter names]`` for the public functions, classes and
    methods of a module (a class maps to ``[]``), and ``--flag -> []`` for
    its command-line flags."""
    tree = ast.parse(source)
    out = {}
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if isinstance(node, funcs) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = []
            for sub in node.body:
                if isinstance(sub, funcs) and (not sub.name.startswith("_") or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            for arg in node.args:
                if isinstance(arg, ast.Constant) and str(arg.value).startswith("--"):
                    out[arg.value] = []
    return out


def missing(jax_source: str, port_source: str) -> list:
    """What the JAX module has and its twin lacks, allowlisted idioms aside:
    ``name`` for a function, class, method or flag, ``name(param)`` for a
    parameter."""
    want, got = api(jax_source), api(port_source)
    out = []
    for name, params in want.items():
        if name not in got:
            if name.rsplit(".", 1)[-1] not in IDIOM_FUNCS:
                out.append(name)
            continue
        out += [f"{name}({p})" for p in params
                if p not in got[name] and p.lstrip("*") not in IDIOM_PARAMS]
    return out


@pytest.mark.parametrize("rel", JAX_FILES)
def test_port_twin_carries_the_jax_api(rel):
    twin = PORT / rel
    if rel in NO_TWIN_FILES:
        assert not twin.exists() and (PORT / NO_TWIN_FILES[rel]).is_file(), rel
        return
    assert twin.is_file(), f"src/repro_torch/{rel} is missing"
    gaps = missing((JAX / rel).read_text(), twin.read_text())
    assert gaps == [], f"src/repro_torch/{rel} lacks {gaps}"


def test_every_allowlisted_idiom_is_still_a_jax_name():
    params, funcs = set(), set()
    for rel in JAX_FILES:
        for name, ps in api((JAX / rel).read_text()).items():
            funcs.add(name.rsplit(".", 1)[-1])
            params.update(p.lstrip("*") for p in ps)
    assert set(IDIOM_PARAMS) <= params, sorted(set(IDIOM_PARAMS) - params)
    assert set(IDIOM_FUNCS) <= funcs, sorted(set(IDIOM_FUNCS) - funcs)
    assert all((JAX / rel).is_file() for rel in NO_TWIN_FILES)


@pytest.mark.parametrize("rel", sorted(MUST_TWIN))
def test_graph_side_options_are_not_allowlisted(rel):
    """The graph side's options and utilities stand in both APIs by name,
    and none of them is an allowlisted idiom."""
    want, got = api((JAX / rel).read_text()), api((PORT / rel).read_text())
    for item in MUST_TWIN[rel]:
        name, _, param = item.partition("(")
        param = param.rstrip(")")
        leaf = name.rsplit(".", 1)[-1]
        assert leaf not in IDIOM_FUNCS and param not in IDIOM_PARAMS, item
        assert name in want and name in got, item
        if param:
            assert param in want[name] and param in got[name], item


def test_the_walk_reports_what_a_twin_lacks():
    jax_src = (
        "import argparse\n"
        "def f(a, b, key=None, *, c=1): pass\n"
        "def on_tpu(): pass\n"
        "def _private(): pass\n"
        "class C:\n"
        "    def __init__(self, x, y): pass\n"
        "    def m(self, z): pass\n"
        "    def _hidden(self): pass\n"
        "    @property\n"
        "    def p(self): pass\n"
        "ap = argparse.ArgumentParser()\n"
        "ap.add_argument('--alpha')\n"
        "ap.add_argument('--beta', type=int)\n"
    )
    port_src = (
        "import argparse\n"
        "def f(a, gen=None): pass\n"
        "class C:\n"
        "    def __init__(self, x): pass\n"
        "ap = argparse.ArgumentParser()\n"
        "ap.add_argument('--alpha')\n"
    )
    assert sorted(missing(jax_src, port_src)) == sorted(
        ["f(b)", "f(c)", "C.__init__(y)", "C.m", "C.p", "--beta"])
    assert missing(jax_src, jax_src) == []
