"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); it builds the
port's kernels from ``src/repro_torch/csrc`` first. Phases:

0. environment: the card's name and power limit, torch and CUDA versions,
   the kernel build time;
1. every kernel against its plain PyTorch version on the card, at test
   shapes and at the shapes the main path gives it, with times;
2. the main path at the paper's scale (filesystem, GIS, Twitter at
   ``scale=1.0``, k=4): random, hard-coded and DiDiC partitions, the
   paper's 10 000-op evaluation log replayed through the service on the
   card, exactness of the batched engine against the scalar oracle on
   the first 64 ops, DiDiC's run-to-run determinism;
3. DiDiC's ``bell_matmul`` route on GIS at ``scale=0.01``.

The main path is each replay of phase 2 and the kernel-route DiDiC run of
phase 3: the launch counts are set to 0 just before each of them and read
just after, and their sum is each kernel's ``launches``.

It prints one line per check, then a JSON line with every kernel's
record, the ``nvidia-smi`` name and power-limit line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is not 0 and the last line is never printed. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
N_OPS = 10_000               # the paper's evaluation-log length (§6.1)
DIDIC_ITERATIONS = 100       # the paper's initial partitioning (§7.3)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}", flush=True)


def say(*parts) -> None:
    print(*parts, flush=True)


def time_cuda(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------
def phase0():
    from repro_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"phase 0: card {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = kernels.build_all()
    say(f"phase 0: built {built} in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for k in kernels.KERNELS.values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {k.name}: {line.strip()}")
    say("phase 0: kernels of this slice: " + ", ".join(sorted(kernels.KERNELS)))
    return smi


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def _random_layout(rng, n, e, cap):
    from repro_torch.graphs.structure import padded_neighbors

    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    return padded_neighbors(s, r, w, n, cap=cap)


def phase1_frontier(dev, gis_engine, records):
    from repro_torch.kernels.frontier import frontier_gather, frontier_gather_ref, make_frontier_gather
    from repro_torch.kernels.frontier.ops import spill_epilogue

    rng = np.random.default_rng(0)
    for cap in (None, 3):
        pn = _random_layout(rng, 2000, 16000, cap)
        if cap is not None:
            check(pn.n_spill > 0, f"frontier_gather capped layout spills ({pn.n_spill} edges)")
        for c in (7, 128, 300):
            x = torch.as_tensor(rng.normal(size=(2000, c)).astype(np.float32), device=dev)
            x[rng.random(2000) < 0.1] = float("inf")
            for mode in ("min", "sum"):
                got = make_frontier_gather(pn, mode=mode, device=dev)(x)
                nbr = torch.as_tensor(pn.nbr, device=dev)
                w = (np.where(pn.mask > 0, pn.w, np.float32(np.inf)) if mode == "min"
                     else pn.w * pn.mask)
                w = torch.as_tensor(w.astype(np.float32), device=dev)
                want = frontier_gather_ref(x, nbr, w, mode=mode)
                want = spill_epilogue(
                    want, x, torch.as_tensor(pn.spill_s, device=dev).long(),
                    torch.as_tensor(pn.spill_r, device=dev).long(),
                    torch.as_tensor(pn.spill_w, device=dev), mode,
                )
                if mode == "min":
                    check(torch.equal(got, want), f"frontier_gather min cap={cap} C={c}: bit-exact")
                else:
                    fin = torch.isfinite(want)
                    check(torch.equal(fin, torch.isfinite(got)) and torch.allclose(
                        got[fin], want[fin], rtol=1e-5, atol=1e-5),
                        f"frontier_gather sum cap={cap} C={c}: within 1e-5")

    # The main path's shape: the whole-graph GIS layout at scale 1.0, C=128.
    w_pad, nbr, w_inf, *_ = gis_engine.ensure_full_layout()
    v, d = nbr.shape
    g = torch.rand((w_pad, 128), generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev) * 5.0
    g[torch.rand((w_pad, 128), device=dev) < 0.5] = float("inf")
    got = frontier_gather(g, nbr, w_inf, mode="min")
    want = frontier_gather_ref(g, nbr, w_inf, mode="min")
    check(torch.equal(got, want), f"frontier_gather min on the GIS full layout [{v}x{d}], C=128: bit-exact")
    err = float((got - want).nan_to_num(0.0, 0.0, 0.0).abs().max())
    ms = time_cuda(lambda: frontier_gather(g, nbr, w_inf, mode="min"))
    plain_ms = time_cuda(lambda: frontier_gather_ref(g, nbr, w_inf, mode="min"), reps=5)
    n_bytes = w_pad * 128 * 4 + v * d * 8 + v * 128 * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * v * d * 128)
    say(f"phase 1: frontier_gather min [{v}x{d}] C=128: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), library: none (no single PyTorch call computes a min-plus gather)")
    records["frontier_gather"] = {
        "name": "frontier_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/frontier_gather.cu",
        "replaces": "src/repro/kernels/frontier/kernel.py:58",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def _bsr_library(bell, dev):
    """``torch.sparse_bsr_tensor`` of the stored blocks (the yardstick)."""
    m = bell.block_mask > 0
    crow = torch.as_tensor(np.concatenate([[0], np.cumsum(m.sum(1))]), dtype=torch.int64)
    col = torch.as_tensor(bell.block_cols[m], dtype=torch.int64)
    vals = torch.as_tensor(bell.blocks[m])
    return torch.sparse_bsr_tensor(
        crow, col, vals, size=(bell.padded_rows, bell.padded_rows), check_invariants=True,
    ).to(dev)


def phase1_bell(dev, records):
    from repro_torch.core.didic import _edge_coefficients
    from repro_torch.graphs import datasets, generators
    from repro_torch.graphs.structure import Graph
    from repro_torch.kernels.bsr_spmm import bell_matmul, bell_matmul_ref

    rng = np.random.default_rng(1)
    g = generators.two_cluster(n_per=70, p_in=0.2, p_out=0.02, seed=1)
    for bs in (16, 32, 128):
        bell = g.to_block_ell(block_size=bs)
        cols = torch.as_tensor(bell.block_cols, device=dev)
        mask = torch.as_tensor(bell.block_mask, device=dev).to(torch.int32)
        for f in (4, 20, 128):
            x32 = torch.as_tensor(rng.normal(size=(bell.padded_rows, f)).astype(np.float32), device=dev)
            for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
                blocks = torch.as_tensor(bell.blocks, device=dev).to(dt)
                x = x32.to(dt)
                got = bell_matmul(blocks, cols, mask, x).float()
                want = bell_matmul_ref(blocks, cols, mask, x).float()
                check(torch.allclose(got, want, rtol=tol, atol=tol),
                      f"bell_matmul bs={bs} F={f} {str(dt)[6:]}: within {tol:g}")

    # The main path's shape: DiDiC's coefficient matrix of GIS at scale 0.01.
    gis = datasets.load("gis", scale=0.01)
    s, r, ce, _ = _edge_coefficients(gis)
    bell = Graph(n_nodes=gis.n_nodes, senders=s, receivers=r, edge_weight=ce).to_block_ell(
        block_size=128, undirected=False)
    blocks = torch.as_tensor(bell.blocks, device=dev)
    cols = torch.as_tensor(bell.block_cols, device=dev)
    mask = torch.as_tensor(bell.block_mask, device=dev).to(torch.int32)
    x = torch.as_tensor(rng.normal(size=(bell.padded_rows, 4)).astype(np.float32), device=dev)
    got = bell_matmul(blocks, cols, mask, x)
    want = bell_matmul_ref(blocks, cols, mask, x)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"bell_matmul on DiDiC's GIS 0.01 matrix ({bell.n_block_rows}x{bell.max_nnzb} slots): within 1e-5")
    lib = _bsr_library(bell, dev)
    lib_out = lib @ x
    check(torch.allclose(lib_out, want, rtol=1e-4, atol=1e-4), "BSR library call agrees (yardstick)")
    ms = time_cuda(lambda: bell_matmul(blocks, cols, mask, x))
    plain_ms = time_cuda(lambda: bell_matmul_ref(blocks, cols, mask, x), reps=5)
    library_ms = time_cuda(lambda: lib @ x)
    nnzb = int(bell.block_mask.sum())
    bs = bell.block_size
    n_bytes = nnzb * bs * bs * 4 + bell.block_cols.size * 8 + 2 * bell.padded_rows * 4 * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * nnzb * bs * bs * 4)
    say(f"phase 1: bell_matmul GIS 0.01 ({nnzb} stored blocks of {bell.n_block_rows}x{bell.max_nnzb}), F=4: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch BSR @ dense {library_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    records["bell_matmul"] = {
        "name": "bell_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/bell_matmul.cu",
        "replaces": "src/repro/kernels/bsr_spmm/kernel.py:52",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def _exact(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("per_op_total", "per_op_global", "per_partition", "per_vertex"))


def _add_counts(main_launches, counts) -> None:
    for kname, n in counts.items():
        main_launches[kname] = main_launches.get(kname, 0) + n


def phase2_dataset(name, graph, dev, main_launches):
    """Drive the static experiment on one dataset. The launch counts of
    each main-path replay (counts set to 0 just before it, read just after)
    are added into ``main_launches``; the checks that follow launch kernels
    too, but outside those windows."""
    from repro_torch import kernels
    from repro_torch.core import metrics, partitioners
    from repro_torch.core.didic import DidicConfig, didic_partition
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.traffic import OpLog, execute_ops

    k = 4
    config = DidicConfig(k=k, iterations=DIDIC_ITERATIONS, smooth_cap=256 if name == "filesystem" else 64)
    svc = PartitionedGraphService(graph, k, config, device=dev)
    ops = svc.make_ops(n_ops=N_OPS, seed=0)
    say(f"phase 2: {graph.summary()}; log {ops.pattern}, {ops.n_ops} ops")

    parts = {"random": partitioners.random_partition(graph.n_nodes, k, seed=0)}
    hard = partitioners.hardcoded_for(graph, k)
    if hard is not None:
        parts["hardcoded"] = hard
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.partition_didic(seed=0)
    torch.cuda.synchronize()
    didic_s = time.perf_counter() - t0
    parts["didic"] = svc.parts.copy()
    say(f"phase 2: {name} DiDiC {DIDIC_ITERATIONS} iterations (segment route): {didic_s:.2f} s, "
        f"{didic_s / DIDIC_ITERATIONS * 1e3:.2f} ms/iteration")

    tg = {}
    for pname, p in parts.items():
        svc.partition_with(p)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = svc.run_ops(ops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        _add_counts(main_launches, counts)
        launched = counts["frontier_gather"]
        rep = svc.report()
        tg[pname] = res.percent_global
        say(json.dumps({
            "phase": 2, "dataset": name, "partitioning": pname,
            "edge_cut_fraction": rep["edge_cut_fraction"], "modularity": rep["modularity"],
            "T_G_percent": 100.0 * res.percent_global,
            "load_cv_traffic": metrics.coefficient_of_variation(res.per_partition),
            "replay_s": wall, "ops_per_s": ops.n_ops / wall,
            "didic_ms_per_iteration": didic_s / DIDIC_ITERATIONS * 1e3 if pname == "didic" else None,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "frontier_gather_launches": launched,
        }))
        if name == "gis":
            check(launched > 0, f"gis {pname}: the replay went through frontier_gather ({launched} launches)")

    sub = OpLog(ops.pattern, ops.starts[:64].copy(), ops.ends[:64].copy(), ops.t_l, ops.t_pg)
    for pname in ("random", "didic"):
        got = execute_ops(graph, sub, parts[pname], k, engine="batched", device=dev)
        want = execute_ops(graph, sub, parts[pname], k, engine="scalar")
        check(_exact(got, want), f"{name} {pname}: batched on the card == scalar oracle, 64 ops, all four counters")

    check(tg["didic"] < tg["random"], f"{name}: DiDiC T_G% {100 * tg['didic']:.3f} < random {100 * tg['random']:.3f}")
    say(f"phase 2: {name} DiDiC cuts global traffic by {100 * (1 - tg['didic'] / tg['random']):.1f}% "
        f"vs random (paper: 40-90%, abstract and §7.3.3)")

    five = DidicConfig(k=k, iterations=5, smooth_cap=config.smooth_cap)
    p1, s1 = didic_partition(graph, five, seed=1, device=dev)
    p2, s2 = didic_partition(graph, five, seed=1, device=dev)
    check(np.array_equal(p1, p2) and torch.equal(s1.w, s2.w),
          f"{name}: segment-route DiDiC, 5 iterations twice: bit-equal parts and w")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
def phase3(dev, main_launches):
    """DiDiC's kernel route against its segment route. The kernel route's
    run is the main path here: its launch counts (set to 0 just before it,
    read just after) are added into ``main_launches``."""
    from repro_torch import kernels
    from repro_torch.core import metrics
    from repro_torch.core.didic import DidicConfig, didic_partition
    from repro_torch.graphs import datasets

    gis = datasets.load("gis", scale=0.01)
    cuts = {}
    for use_kernel in (False, True):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        p, _ = didic_partition(
            gis, DidicConfig(k=4, iterations=20, use_kernel=use_kernel, block_size=128),
            seed=0, device=dev,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        route = "kernel" if use_kernel else "segment"
        cuts[route] = metrics.edge_cut_fraction(gis, p)
        launched = counts["bell_matmul"]
        say(f"phase 3: GIS 0.01 DiDiC {route} route, 20 iterations: edge cut {cuts[route]:.4f}, "
            f"{wall / 20 * 1e3:.2f} ms/iteration, bell_matmul launches {launched}")
        if use_kernel:
            _add_counts(main_launches, counts)
            check(launched > 0, "DiDiC's kernel route went through bell_matmul")
        else:
            check(launched == 0, "DiDiC's segment route launched no bell_matmul")
    ratio = max(cuts.values()) / max(min(cuts.values()), 1e-12)
    check(ratio <= 1.5, f"kernel-route edge cut within 1.5x of the segment route's ({ratio:.3f}x)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase0()

    from repro_torch.core.traffic_batched import get_engine
    from repro_torch.graphs import datasets

    graphs = {}
    for name in ("filesystem", "gis", "twitter"):
        t0 = time.perf_counter()
        graphs[name] = datasets.load(name, scale=1.0, seed=0)
        say(f"loaded {graphs[name].summary()} in {time.perf_counter() - t0:.2f} s")

    records = {}
    phase1_frontier(dev, get_engine(graphs["gis"], "gis_short", device=dev), records)
    phase1_bell(dev, records)
    say(f"phase 1 done at {time.perf_counter() - t_start:.1f} s")

    main_launches = {}
    for name, graph in graphs.items():
        phase2_dataset(name, graph, dev, main_launches)
        say(f"phase 2 {name} done at {time.perf_counter() - t_start:.1f} s")
    phase3(dev, main_launches)
    say(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    say("main-path launches (the replays of phase 2 and the kernel-route DiDiC of phase 3): "
        + json.dumps(main_launches, sort_keys=True))
    for name in ("frontier_gather", "bell_matmul"):
        n = main_launches.get(name, 0)
        check(n > 0, f"{name} launched on the main path ({n} times)")
        records[name]["launches"] = n

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: records[n][k] for k in keys}
                                  for n in ("frontier_gather", "bell_matmul")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
