"""The dry run on the ``meta`` device: every (arch × shape × mesh) cell,
rank 0's step, nothing allocated (twin of ``repro.launch.dryrun``).

The JAX dry run lowers and compiles each cell on 512 forced host devices
and reads XLA's memory analysis, cost analysis and the collectives of the
compiled HLO. The port has no compiler: it builds each runnable cell's
spec on the production mesh (:func:`~repro_torch.launch.mesh.
make_production_mesh`, a :class:`~repro_torch.launch.mesh.MetaMesh` that
plays rank 0), cuts rank 0's arguments from the ``meta`` abstract ones
(:func:`~repro_torch.configs.base.rank_args`) and runs its step once under
``torch.utils.flop_counter.FlopCounterMode``. Every kernel reaches its
plain version there (the dispatch sends ``meta`` tensors to it). Per cell
and mesh it appends one JSON line with

* ``bytes_per_device``: parameters, optimizer state and batch (and the KV
  cache or candidates, by the cell's kind) under the cell's specs, the JAX
  layout; ``bytes_per_device_as_run``: the same under the placement the
  port's step runs (the same in every LM cell, which runs the JAX layout;
  DIN's tables whole along the model axis);
* ``collectives``: the bytes each collective kind receives on rank 0, in
  the JAX dry run's layout;
* ``flops_per_device``: the FLOPs the counter saw in rank 0's step;
* ``analytic_flops_per_device``: ``analytic_model_flops`` for the GNN and
  DIN cells; for an LM 6·N_active·tokens / devices for ``train_4k`` and
  2·N_active·tokens / devices for prefill and decode (tokens as
  ``benchmarks/roofline.py`` counts them; its decode adds an attention
  term, left out here), and ``flops_ratio``, counted over analytic;
* ``output_shapes``: each output leaf's shape and dtype;
* ``memory_analysis``: ``null``, with ``memory_analysis_reason``.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--out results/dryrun_torch.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional, Sequence

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed.sharding import leaf_shards
from repro_torch.launch.mesh import make_production_mesh

MEMORY_ANALYSIS_REASON = ("no compiler, so no buffer assignment: torch runs the step op by op, and "
                          "on meta allocates nothing")

LM_SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,          # one token per sequence
}

# Names of the positional arguments, by the cell's kind.
_ARG_NAMES = {
    "train": ("params", "opt_state", "batch"),
    "prefill": ("params", "batch"),
    "decode": ("params", "batch", "kv_cache"),
    "serve": ("params", "batch"),
    "retrieval": ("params", "batch", "candidates", "candidates"),
}


def leaves_with_specs(args, specs, path=()):
    """``(path, leaf, spec)`` of every tensor in ``args`` with its spec in
    the matching ``specs`` tree, the path's keys joined by '.'."""
    if isinstance(args, dict):
        for k, v in args.items():
            yield from leaves_with_specs(v, specs[k], path + (k,))
    elif isinstance(args, (tuple, list)):
        for i, (v, s) in enumerate(zip(args, specs)):
            yield from leaves_with_specs(v, s, path + (str(i),))
    else:
        yield ".".join(path), args, specs


def _per_device_bytes(spec, mesh, as_run: bool) -> Dict[str, int]:
    """Bytes of rank 0's arguments, by name: each leaf's bytes over the
    ranks its spec splits it across (under the specs the step runs, when
    ``as_run``)."""
    specs = (spec.run_specs or spec.in_specs) if as_run else spec.in_specs
    out: Dict[str, int] = {}
    for i, (arg, s) in enumerate(zip(spec.abstract_args, specs)):
        name = _ARG_NAMES[spec.kind][i]
        for _, leaf, leaf_spec in leaves_with_specs(arg, s, (str(i),)):
            out[name] = out.get(name, 0) + leaf.numel() * leaf.element_size() // leaf_shards(leaf_spec, mesh)
    return out


def output_shapes(out, path=()) -> Dict[str, list]:
    """``{path: [shape, dtype]}`` of every tensor in a step's output, the
    path's keys joined by '/'."""
    if isinstance(out, dict):
        return {k: v for key, sub in out.items() for k, v in output_shapes(sub, path + (key,)).items()}
    if isinstance(out, (tuple, list)):
        return {k: v for i, sub in enumerate(out) for k, v in output_shapes(sub, path + (str(i),)).items()}
    return {"/".join(path): [list(out.shape), str(out.dtype).replace("torch.", "")]}


def lm_model_flops(meta: Dict, shape: str, kind: str, n_devices: int) -> Optional[float]:
    """6·N_active·tokens (train) or 2·N_active·tokens (prefill, decode)
    per device, from the arch's ``meta`` parameter counts."""
    active = meta.get("active_params", meta.get("params"))
    toks = LM_SHAPE_TOKENS.get(shape)
    if active is None or toks is None:
        return None
    return (6.0 if kind == "train" else 2.0) * active * toks / n_devices


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True) -> dict:
    from repro_torch.configs import get
    from repro_torch.configs.base import analytic_model_flops, rank_args

    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get(arch)
    t0 = time.perf_counter()
    spec = cfg.dryrun(shape, mesh)
    args = rank_args(spec, mesh)
    t_build = time.perf_counter() - t0
    with FlopCounterMode(display=False) as counter:
        out = spec.step_fn(*args)
    t_run = time.perf_counter() - t0 - t_build
    n_dev = mesh.size
    flops = float(counter.get_total_flops())
    if cfg.family == "lm":
        analytic = lm_model_flops(cfg.meta, shape, spec.kind, n_dev)
    else:
        analytic = analytic_model_flops(arch, shape, n_dev)
    coll = mesh.collective_stats()
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "kind": spec.kind,
        "build_s": t_build,
        "run_s": t_run,
        "bytes_per_device": _per_device_bytes(spec, mesh, as_run=False),
        "bytes_per_device_as_run": _per_device_bytes(spec, mesh, as_run=True),
        "collectives": coll,
        "flops_per_device": flops,
        "analytic_flops_per_device": analytic,
        "flops_ratio": flops / analytic if analytic else None,
        "output_shapes": output_shapes(out),
        "memory_analysis": None,
        "memory_analysis_reason": MEMORY_ANALYSIS_REASON,
        "meta": cfg.meta,
    }
    if verbose:
        b = result["bytes_per_device"]
        print(
            f"[dryrun] {arch} × {shape} × {result['mesh']}: OK "
            f"(build {t_build:.1f}s, run {t_run:.1f}s, flops {flops:.3e}"
            + (f" ({flops / analytic:.2f}× analytic)" if analytic else "")
            + f", coll {coll['total_bytes'] / 1e9:.2f} GB, "
            f"args/dev {sum(b.values()) / 1e9:.2f} GB)",
            flush=True,
        )
    return result


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun_torch.jsonl")
    ap.add_argument("--skip-done", action="store_true", help="skip cells already present in --out")
    args = ap.parse_args(argv)

    from repro_torch.configs import all_cells, skipped_cells

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    done = set()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") == "ok":
                    done.add((r["arch"], r["shape"], r["mesh"]))

    for skip in skipped_cells():
        print(f"[dryrun] SKIP {skip[0]} × {skip[1]}: {skip[2]}")

    failures = []
    with open(args.out, "a") as f:
        for arch, shape in cells:
            for multi in meshes:
                mesh_name = "2x16x16" if multi else "16x16"
                if (arch, shape, mesh_name) in done:
                    print(f"[dryrun] {arch} × {shape} × {mesh_name}: already done")
                    continue
                try:
                    r = run_cell(arch, shape, multi)
                    r["status"] = "ok"
                except Exception as e:  # noqa: BLE001 — report and continue
                    traceback.print_exc()
                    r = {"arch": arch, "shape": shape, "mesh": mesh_name,
                         "status": "fail", "error": f"{type(e).__name__}: {e}"}
                    failures.append((arch, shape, mesh_name))
                f.write(json.dumps(r) + "\n")
                f.flush()
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all requested cells ran on meta")


if __name__ == "__main__":
    main()
