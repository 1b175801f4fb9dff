"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); it builds the
port's kernels from ``src/repro_torch/csrc`` first. Phases:

0. environment: the card's name and power limit, torch and CUDA versions,
   the kernel build time;
1. every kernel against its plain PyTorch version on the card, at test
   shapes and at the shapes the main path gives it, with times
   (``embedding_bag`` at its main-path shape in phase 4, on DIN's batch,
   where two launches must give the same bits); ``frontier_gather``'s min
   with NaN and -inf in x against the plain version's NaN mask and
   values, and on the GIS whole-graph layout with the engine's row
   schedule, without it, and with the spill tail; ``flash_attention``'s
   previous (float32-pipe) design is timed beside its tensor-core kernel
   on the same bfloat16 inputs, and two ``bell_matmul`` launches on
   DiDiC's matrix must give the same bits;
2. the main path at the paper's scale (filesystem, GIS, Twitter at
   ``scale=1.0``, k=4): random, hard-coded and DiDiC partitions, the
   paper's 10 000-op evaluation log replayed through the service on the
   card, exactness of the batched engine against the scalar oracle on
   the first 64 ops, DiDiC's run-to-run determinism;
3. DiDiC's ``bell_matmul`` route on GIS at ``scale=0.01``;
4. DIN at its full config (``configs/din.FULL``): scoring 262,144
   requests, the user tower through ``embedding_bag``, one user against
   1,000,000 candidates;
5. granite-3-8b at its full config and depth (``configs/granite_3_8b.FULL``,
   random bf16 weights): the forward pass and loss over 4,096 tokens
   through ``flash_attention`` (every launch on its tensor-core route),
   then the continuous-batching server answering 8 requests, twice;
6. the paper's dynamic experiments (Chapter 7) at ``scale=1.0``, k=4, run
   after phase 3 from phase 2's DiDiC maps and carried states: Insert
   (three insert methods at 5 % and 25 % dynamism), Stress (25 %, one cold
   DiDiC iteration; on GIS at ``scale=0.01`` through ``bell_matmul`` too),
   Dynamic (5 maintained slices of 5 % against the unmaintained map;
   Twitter twice), Insert with vertex growth (4 slices, 30 % inserts) and
   the maintenance cost; GIS replays a 2,000-op log here.

Each kernel's ``launches`` come from its main-path runs: each replay of
phase 2 (``frontier_gather``), the kernel-route DiDiC run of phase 3
(``bell_matmul``), the ``user_vector`` call of phase 4 (``embedding_bag``),
the granite forward call of phase 5 (``flash_attention``) and every replay
and maintenance run of phase 6 (``frontier_gather``, ``bell_matmul``). The launch
counts are set to 0 just before each of them and read just after. Each
kernel's ``ms`` is one call between two CUDA events, its wrapper's host
work included; its phase line also gives its time a call over 10 calls
back to back, where the host enqueues the next call while the card runs.

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
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 on the tensor cores
N_OPS = 10_000               # the paper's evaluation-log length (§6.1)
DIDIC_ITERATIONS = 100       # the paper's initial partitioning (§7.3)
B2B = 10                     # calls a back-to-back time runs (each kernel's ms is one call)
KERNEL_ORDER = ("frontier_gather", "bell_matmul", "embedding_bag", "flash_attention")


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}", flush=True)


def say(*parts) -> None:
    print(*parts, flush=True)


def time_cuda(fn, reps: int = 10, warmup: int = 2, inner: int = 1):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events, and
    the result of its last run. Host work inside ``fn`` counts: the stream
    waits for it between the two events. With ``inner`` > 1 a run is
    ``inner`` calls back to back, divided by ``inner``: the card then runs
    the calls one after another while the host enqueues the next, so a
    call's host work counts only where it is longer than its device time.
    The kernels' ``ms`` are single calls (``inner`` 1); their back-to-back
    times are printed beside them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times), out


def once(fn):
    """``fn``'s result and its time in seconds, one run with no warm-up."""
    ms, out = time_cuda(fn, reps=1, warmup=0)
    return out, ms / 1e3


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
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


def _nan_equal(a, b) -> bool:
    """The same NaN mask, and equal values everywhere else (inf included)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0))


def phase1_frontier(dev, gis_engine, records):
    from repro_torch.kernels.frontier import (
        frontier_gather, frontier_gather_ref, frontier_relax, make_frontier_gather, spill_tail,
    )

    rng = np.random.default_rng(0)
    for cap in (None, 3):
        pn = _random_layout(rng, 2000, 16000, cap)
        if cap is not None:
            check(pn.n_spill > 0, f"frontier_gather capped layout spills ({pn.n_spill} edges)")
        nbr = torch.as_tensor(pn.nbr, device=dev)
        tail = spill_tail(pn.spill_s, pn.spill_r, pn.spill_w, 2000, dev)
        for c in (7, 128, 300):
            x = torch.as_tensor(rng.normal(size=(2000, c)).astype(np.float32), device=dev)
            x[rng.random(2000) < 0.1] = float("inf")
            for mode in ("min", "sum"):
                got = make_frontier_gather(pn, mode=mode, device=dev)(x)
                w = (np.where(pn.mask > 0, pn.w, np.float32(np.inf)) if mode == "min"
                     else pn.w * pn.mask)
                w = torch.as_tensor(w.astype(np.float32), device=dev)
                want = frontier_gather_ref(x, nbr, w, mode=mode, tail=tail)
                if mode == "min":
                    check(torch.equal(got, want), f"frontier_gather min cap={cap} C={c}: bit-exact")
                else:
                    fin = torch.isfinite(want)
                    check(torch.equal(fin, torch.isfinite(got)) and torch.allclose(
                        got[fin], want[fin], rtol=1e-5, atol=1e-5),
                        f"frontier_gather sum cap={cap} C={c}: within 1e-5")

    # NaN and -inf in x, row 0 included (every padded slot reads it with
    # weight +inf, and -inf + +inf is NaN): min propagates NaN as
    # torch.minimum does, over the padded slots and over the spill tail;
    # the plain version's scatter-min on the card is held to the CPU's too.
    for cap in (None, 3):
        pn = _random_layout(rng, 2000, 16000, cap)
        nbr = torch.as_tensor(pn.nbr, device=dev)
        w = torch.as_tensor(np.where(pn.mask > 0, pn.w, np.float32(np.inf)), device=dev)
        tail = spill_tail(pn.spill_s, pn.spill_r, pn.spill_w, 2000, dev)
        cpu_tail = spill_tail(pn.spill_s, pn.spill_r, pn.spill_w, 2000, "cpu")
        for c in (7, 128):
            xh = rng.normal(size=(2000, c)).astype(np.float32)
            xh[0, :3] = [np.nan, -np.inf, np.inf]
            xh[rng.random((2000, c)) < 0.02] = np.nan
            xh[rng.random((2000, c)) < 0.02] = -np.inf
            x = torch.as_tensor(xh, device=dev)
            got = frontier_gather(x, nbr, w, mode="min", tail=tail)
            on_cpu = frontier_gather_ref(x.cpu(), nbr.cpu(), w.cpu(), mode="min", tail=cpu_tail)
            check(bool(torch.isnan(got).any()) and _nan_equal(got.cpu(), on_cpu),
                  f"frontier_gather min cap={cap} C={c} with NaN and -inf in x (row 0 too): the plain "
                  f"version's NaN mask and values")
            check(_nan_equal(frontier_gather_ref(x, nbr, w, mode="min", tail=tail).cpu(), on_cpu),
                  f"the plain version on the card (torch.minimum, scatter_reduce amin) cap={cap} C={c}: "
                  f"the CPU's NaN mask and values")

    # The main path's shape: the whole-graph GIS layout at scale 1.0, C=128,
    # with the engine's row schedule (the replay's redo chunks use it) and
    # without one, without its spill tail (the function earlier designs were
    # timed on) and with it (the replay's call).
    w_pad, nbr, w_inf, tail, *_ = gis_engine.ensure_full_layout()
    order = gis_engine.full_row_order()
    check(order is not None and torch.equal(torch.sort(order).values,
                                            torch.arange(w_pad, dtype=torch.int32, device=dev)),
          f"the engine's row schedule of the GIS full layout is a permutation of its {w_pad} rows")
    v, d = nbr.shape
    n_tail = int(tail.src.shape[0])
    g = torch.rand((w_pad, 128), generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev) * 5.0
    g[torch.rand((w_pad, 128), device=dev) < 0.5] = float("inf")
    got = frontier_gather(g, nbr, w_inf, mode="min", order=order)
    want = frontier_gather_ref(g, nbr, w_inf, mode="min")
    check(torch.equal(got, want), f"frontier_gather min on the GIS full layout [{v}x{d}], C=128, "
                                  f"with the engine's row schedule: bit-exact")
    check(torch.equal(frontier_gather(g, nbr, w_inf, mode="min"), want),
          "frontier_gather min on the GIS full layout without a row schedule: bit-exact")
    check(torch.equal(frontier_relax(g, nbr, w_inf, tail, order),
                      frontier_gather_ref(g, nbr, w_inf, mode="min", tail=tail)),
          f"frontier_relax on the GIS full layout with its spill tail ({n_tail} edges): bit-exact")
    err = float((got - want).nan_to_num(0.0, 0.0, 0.0).abs().max())
    ms = time_cuda(lambda: frontier_gather(g, nbr, w_inf, mode="min", order=order))[0]
    b2b_ms = time_cuda(lambda: frontier_gather(g, nbr, w_inf, mode="min", order=order), inner=B2B)[0]
    unordered_ms = time_cuda(lambda: frontier_gather(g, nbr, w_inf, mode="min"))[0]
    unordered_b2b_ms = time_cuda(lambda: frontier_gather(g, nbr, w_inf, mode="min"), inner=B2B)[0]
    relax_ms = time_cuda(lambda: frontier_relax(g, nbr, w_inf, tail, order))[0]
    relax_b2b_ms = time_cuda(lambda: frontier_relax(g, nbr, w_inf, tail, order), inner=B2B)[0]
    plain_ms = time_cuda(lambda: frontier_gather_ref(g, nbr, w_inf, mode="min"), reps=5)[0]
    n_bytes = w_pad * 128 * 4 + v * d * 8 + v * 128 * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * v * d * 128)
    say(f"phase 1: frontier_gather min [{v}x{d}] C=128: kernel with the row schedule {ms:.4f} ms "
        f"({100 * b_ms / ms:.1f} % of the bound), without {unordered_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), library: none (no single PyTorch call computes a min-plus gather); "
        f"with the spill tail ({n_tail} edges, the replay's call) {relax_ms:.4f} ms; {B2B} calls back to "
        f"back: kernel with the schedule {b2b_ms:.4f} ms a call ({100 * b_ms / b2b_ms:.1f} % of the bound), "
        f"without {unordered_b2b_ms:.4f} ms, with the spill tail {relax_b2b_ms:.4f} ms")
    records["frontier_gather"] = {
        "name": "frontier_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/frontier_gather.cu",
        "replaces": "src/repro/kernels/frontier/kernel.py:58",
        "max_abs_err": err, "ms": ms, "b2b_ms": b2b_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "unordered_ms": unordered_ms, "unordered_b2b_ms": unordered_b2b_ms,
        "with_tail_ms": relax_ms, "with_tail_b2b_ms": relax_b2b_ms,
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
    check(torch.equal(got, bell_matmul(blocks, cols, mask, x)),
          "bell_matmul on DiDiC's matrix: two launches give the same bits")
    lib = _bsr_library(bell, dev)
    lib_out = lib @ x
    check(torch.allclose(lib_out, want, rtol=1e-4, atol=1e-4), "BSR library call agrees (yardstick)")
    ms = time_cuda(lambda: bell_matmul(blocks, cols, mask, x))[0]
    plain_ms = time_cuda(lambda: bell_matmul_ref(blocks, cols, mask, x), reps=5)[0]
    library_ms = time_cuda(lambda: lib @ x)[0]
    b2b_ms = time_cuda(lambda: bell_matmul(blocks, cols, mask, x), inner=B2B)[0]
    library_b2b_ms = time_cuda(lambda: lib @ x, inner=B2B)[0]
    nnzb = int(bell.block_mask.sum())
    bs = bell.block_size
    n_bytes = nnzb * bs * bs * 4 + bell.block_cols.size * 8 + 2 * bell.padded_rows * 4 * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * nnzb * bs * bs * 4)
    say(f"phase 1: bell_matmul GIS 0.01 ({nnzb} stored blocks of {bell.n_block_rows}x{bell.max_nnzb}), F=4: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch BSR @ dense {library_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); kernel at {100 * b_ms / ms:.1f} % of the bound, "
        f"{n_bytes / ms / 1e6:.1f} GB/s; {B2B} calls back to back: kernel {b2b_ms:.4f} ms a call "
        f"({100 * b_ms / b2b_ms:.1f} % of the bound), torch BSR @ dense {library_b2b_ms:.4f} ms")
    records["bell_matmul"] = {
        "name": "bell_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/bell_matmul.cu",
        "replaces": "src/repro/kernels/bsr_spmm/kernel.py:52",
        "max_abs_err": err, "ms": ms, "b2b_ms": b2b_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def _exact(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("per_op_total", "per_op_global", "per_partition", "per_vertex"))


def _oracle_check(graph, ops, parts, dev, what) -> None:
    from repro_torch.core.traffic import OpLog, execute_ops

    sub = OpLog(ops.pattern, ops.starts[:64].copy(), ops.ends[:64].copy(), ops.t_l, ops.t_pg)
    got = execute_ops(graph, sub, parts, 4, engine="batched", device=dev)
    want = execute_ops(graph, sub, parts, 4, engine="scalar")
    check(_exact(got, want), f"{what}: batched on the card == scalar oracle, 64 ops, all four counters")


def _add_counts(main_launches, counts) -> None:
    for kname, n in counts.items():
        main_launches[kname] = main_launches.get(kname, 0) + n


def phase2_dataset(name, graph, dev, main_launches):
    """Drive the static experiment on one dataset. The launch counts of
    each main-path replay (counts set to 0 just before it, read just after)
    are added into ``main_launches``; the checks that follow launch kernels
    too, but outside those windows. Returns the DiDiC map, its carried
    state and the 100 iterations' seconds, where phase 6 starts."""
    from repro_torch import kernels
    from repro_torch.core import metrics, partitioners
    from repro_torch.core.didic import DidicConfig, didic_partition
    from repro_torch.core.framework import PartitionedGraphService

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

    for pname in ("random", "didic"):
        _oracle_check(graph, ops, parts[pname], dev, f"{name} {pname}")

    check(tg["didic"] < tg["random"], f"{name}: DiDiC T_G% {100 * tg['didic']:.3f} < random {100 * tg['random']:.3f}")
    say(f"phase 2: {name} DiDiC cuts global traffic by {100 * (1 - tg['didic'] / tg['random']):.1f}% "
        f"vs random (paper: 40-90%, abstract and §7.3.3)")

    five = DidicConfig(k=k, iterations=5, smooth_cap=config.smooth_cap)
    p1, s1 = didic_partition(graph, five, seed=1, device=dev)
    p2, s2 = didic_partition(graph, five, seed=1, device=dev)
    check(np.array_equal(p1, p2) and torch.equal(s1.w, s2.w),
          f"{name}: segment-route DiDiC, 5 iterations twice: bit-equal parts and w")
    return parts["didic"], svc.runtime.state, didic_s


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
def phase3(dev, main_launches):
    """DiDiC's kernel route against its segment route. The kernel route's
    run is the main path here: its launch counts (set to 0 just before it,
    read just after) are added into ``main_launches``. Returns the graph
    and the kernel route's map, where phase 6's kernel-route Stress starts."""
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
    return gis, p


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------
N_OPS_GIS_DYNAMIC = 2_000       # phase 6's GIS log (the GIS replay is host-paced)
INSERT_LEVELS = (0.05, 0.25)    # two of the paper's five dynamism levels (§7.4)


class _Timed:
    """A method wrapped to keep the seconds of each call, the card
    synchronised on both sides."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, []

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def _counted(fn, main_launches):
    """Run ``fn`` as a main-path run: the launch counts set to 0 just before
    it, read just after and added into ``main_launches``."""
    from repro_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    _add_counts(main_launches, counts)
    return out, counts


def _service(graph, config, dev, parts, state):
    """A service on ``parts`` with DiDiC's carried ``state`` (``None``: cold),
    its replays and maintenance passes timed."""
    from repro_torch.core.framework import PartitionedGraphService

    svc = PartitionedGraphService(graph, 4, config, device=dev)
    svc.runtime.state = state
    svc.partition_with(parts.copy())
    svc.run_ops = _Timed(svc.run_ops)
    svc.runtime.maintain = _Timed(svc.runtime.maintain)
    return svc


def _bare(graph):
    """The same arrays as a new graph object, with none of its caches."""
    from repro_torch.graphs.structure import Graph

    return Graph(n_nodes=graph.n_nodes, senders=graph.senders, receivers=graph.receivers,
                 edge_weight=graph.edge_weight, node_attrs=graph.node_attrs, name=graph.name)


def _engine_build_seconds(graph, pattern, dev) -> float:
    """Seconds to build what a grown graph's first replay builds: its
    engine, for GIS with the whole-graph layout and row schedule. (Its
    first maintenance pass rebuilds DiDiC's product: that shows in the
    pass's own time.)"""
    from repro_torch.core.traffic_batched import BatchedTrafficEngine

    def build():
        eng = BatchedTrafficEngine(_bare(graph), pattern, device=dev)
        if eng.kind == "sssp":
            eng.ensure_full_layout()
            eng.full_row_order()

    return once(build)[1]


def _pg(res) -> float:
    return 100.0 * res.percent_global


def phase6_dataset(name, graph, start, dev, main_launches):
    """The paper's dynamic experiments (Chapter 7) on one dataset at the
    paper's scale, from phase 2's DiDiC map and carried state, with the
    parameters of the JAX package's ``benchmarks/paper_tables.py``: Insert
    (§7.4), Stress (§7.5), Dynamic (§7.6) with its unmaintained comparator,
    Insert with vertex growth, and the maintenance cost. Every replay and
    maintenance run here is a main-path run (its launches counted)."""
    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.core import metrics
    from repro_torch.core.didic import didic_refine
    from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
    from repro_torch.core.dynamism import apply_dynamism, generate_dynamism
    from repro_torch.core.framework import InsertPartitioner
    from repro_torch.core.traffic import generate_ops

    k = 4
    parts0, state0, didic_s = start
    config = PaperExperimentConfig(didic_iterations=DIDIC_ITERATIONS).didic(name, k)
    n_ops = N_OPS_GIS_DYNAMIC if name == "gis" else N_OPS
    ops = generate_ops(graph, n_ops=n_ops, seed=0)
    say(f"phase 6: {name}, log {ops.pattern}, {n_ops} ops"
        + (" (cut from 10,000: the GIS replay is host-paced)" if name == "gis" else ""))
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": 6, "dataset": name, "n_ops": n_ops}
    fg = 0
    replay_s, refine_s = [], []

    def collect(svc):
        replay_s.extend(svc.run_ops.seconds)
        refine_s.extend(svc.runtime.maintain.seconds)

    # Insert (§7.4): each method at two dynamism levels from the DiDiC map,
    # fed the DiDiC replay's per-vertex traffic.
    svc = _service(graph, config, dev, parts0, state0)
    base, counts = _counted(lambda: svc.run_ops(ops), main_launches)
    fg += counts["frontier_gather"]
    out["didic_T_G_percent"] = _pg(base)
    out["insert"] = {}
    maps = {}
    for method in ("random", "fewest_vertices", "least_traffic"):
        for level in INSERT_LEVELS:
            log = generate_dynamism(parts0, level, method, k=k, vertex_traffic=base.per_vertex, seed=0)
            parts = maps[method, level] = apply_dynamism(parts0, log)
            svc.partition_with(parts)
            res, counts = _counted(lambda: svc.run_ops(ops), main_launches)
            fg += counts["frontier_gather"]
            out["insert"][f"{method}/{int(level * 100)}"] = {
                "T_G_percent": _pg(res),
                "cv_traffic": metrics.coefficient_of_variation(res.per_partition),
            }
    say(f"phase 6: {name} insert T_G % (5 / 25 % dynamism, DiDiC start {out['didic_T_G_percent']:.4f}): "
        + "; ".join(f"{m} {out['insert'][m + '/5']['T_G_percent']:.4f} / {out['insert'][m + '/25']['T_G_percent']:.4f}"
                    for m in ("random", "fewest_vertices", "least_traffic")))
    _oracle_check(graph, ops, maps["least_traffic", 0.25], dev, f"{name} insert, least_traffic 25 % map")
    collect(svc)

    # Stress (§7.5): 25 % random dynamism, one cold DiDiC iteration.
    svc = _service(graph, config, dev, parts0, None)
    stress, counts = _counted(lambda: DynamicExperimentRuntime(svc, "random", seed=0).run(
        ops, n_slices=1, amount=0.25, maintain_every=1, measure_damaged=True), main_launches)
    fg += counts["frontier_gather"]
    rec = stress.records[0]
    out["stress"] = {"base": _pg(stress.baseline), "damaged": 100 * rec.damaged_percent_global,
                     "repaired": 100 * rec.percent_global, "migrated": rec.migrated}
    st = out["stress"]
    check(st["damaged"] > st["base"] and st["repaired"] < st["damaged"],
          f"{name} stress: damaged T_G % {st['damaged']:.4f} > base {st['base']:.4f}, repaired by one "
          f"iteration to {st['repaired']:.4f} ({rec.migrated} migrated; the paper: one iteration repairs 25 %)")
    collect(svc)

    # Dynamic (§7.6): 5 slices of 5 % random dynamism, maintained every slice
    # from the carried state. Random targets read neither the map nor the
    # traffic, so the same partitioner stream regenerates the run's five
    # logs, which applied to the start map give the unmaintained map.
    def dynamic():
        svc = _service(graph, config, dev, parts0, state0)
        run, counts = _counted(lambda: DynamicExperimentRuntime(svc, "random", seed=0).run(
            ops, n_slices=5, amount=0.05, maintain_every=1), main_launches)
        collect(svc)
        return run, counts["frontier_gather"]

    run, n = dynamic()
    fg += n
    out["dynamic"] = [{"T_G_percent": 100 * r.percent_global, "migrated": r.migrated} for r in run.records]
    stream = InsertPartitioner("random", k, seed=0)
    unmaintained = parts0
    for _ in range(5):
        unmaintained = apply_dynamism(unmaintained, stream.allocate(unmaintained, 0.05))
    svc = _service(graph, config, dev, unmaintained, None)
    res, counts = _counted(lambda: svc.run_ops(ops), main_launches)
    fg += counts["frontier_gather"]
    collect(svc)
    out["dynamic_unmaintained_T_G_percent"] = _pg(res)
    say(f"phase 6: {name} dynamic T_G % (migrated) per slice: "
        + ", ".join(f"{r['T_G_percent']:.4f} ({r['migrated']})" for r in out["dynamic"]))
    check(_pg(run.final) < _pg(res),
          f"{name} dynamic: maintained T_G % after 5 slices {_pg(run.final):.4f} < unmaintained {_pg(res):.4f}")
    if name == "twitter":
        again, n = dynamic()
        fg += n
        check([vars(r) for r in again.records] == [vars(r) for r in run.records]
              and np.array_equal(again.parts, run.parts),
              f"{name} dynamic run twice: identical records and final map")

    # Insert with vertex growth: least_traffic, 30 % of the units allocate a
    # vertex, 4 slices of 5 %, maintenance every second slice.
    grown = []
    svc = _service(graph, config, dev, parts0, state0)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    growth, counts = _counted(lambda: DynamicExperimentRuntime(svc, "least_traffic", seed=0).run(
        ops, n_slices=4, amount=0.05, maintain_every=2, insert_rate=0.3,
        on_slice=lambda i, r: grown.append(_bare(svc.graph))), main_launches)
    fg += counts["frontier_gather"]
    growth_peak = torch.cuda.max_memory_allocated()
    n_grown = svc.graph.n_nodes - graph.n_nodes
    check(n_grown == sum(r.inserted for r in growth.records) > 0,
          f"{name} growth: {n_grown} vertices grown over 4 slices, one per insert unit")
    _oracle_check(svc.graph, ops, svc.parts, dev, f"{name} growth, last grown graph ({svc.graph.n_nodes} vertices)")
    growth_replay_s = list(svc.run_ops.seconds)
    growth_refine_s = list(svc.runtime.maintain.seconds)
    collect(svc)
    del svc
    builds = [_engine_build_seconds(g, ops.pattern, dev) for g in grown]
    del grown
    out["growth"] = {
        "records": [{"T_G_percent": 100 * r.percent_global, "inserted": r.inserted,
                     "migrated": r.migrated, "maintained": r.maintained} for r in growth.records],
        "grown_vertices": n_grown, "replay_s": growth_replay_s, "refine_s": growth_refine_s,
        "engine_build_s": builds,
        "peak_device_bytes": growth_peak,
    }
    say(f"phase 6: {name} growth: +{n_grown} vertices, T_G % per slice "
        + ", ".join(f"{r['T_G_percent']:.4f}" for r in out["growth"]["records"])
        + "; engine build a growth slice " + ", ".join(f"{b:.2f}" for b in builds)
        + " s; maintenance on the grown graphs (DiDiC's product rebuilt) "
        + ", ".join(f"{t:.2f}" for t in growth_refine_s) + f" s; peak {growth_peak} B")

    # Maintenance cost: one warm iteration against phase 2's 100.
    _, one_s = once(lambda: didic_refine(graph, parts0, config, state=state0, iterations=1, device=dev))
    out["maintenance"] = {"one_iteration_s": one_s, "initial_100_s": didic_s, "ratio_percent": 100 * one_s / didic_s}
    say(f"phase 6: {name} maintenance: one warm iteration {one_s:.3f} s = {100 * one_s / didic_s:.2f} % of "
        f"the initial {DIDIC_ITERATIONS} iterations' {didic_s:.2f} s (the paper: ~1 %)")

    out["replay_s"] = replay_s
    out["refine_s"] = refine_s
    out["peak_device_bytes"] = max(peak, torch.cuda.max_memory_allocated())
    out["frontier_gather_launches"] = fg
    say(json.dumps(out))
    if name == "gis":
        check(fg > 0, f"gis phase 6: the replays went through frontier_gather ({fg} launches)")


def phase6_bell(gis, parts0, dev, main_launches):
    """The Stress experiment on GIS at ``scale=0.01`` from phase 3's
    kernel-route map and with its config, so that its maintenance runs
    through ``bell_matmul``."""
    from repro_torch.core.didic import DidicConfig
    from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.traffic import generate_ops

    config = DidicConfig(k=4, iterations=20, use_kernel=True, block_size=128)
    svc = PartitionedGraphService(gis, 4, config, device=dev).partition_with(parts0)
    ops = generate_ops(gis, n_ops=N_OPS_GIS_DYNAMIC, seed=0)
    run, counts = _counted(lambda: DynamicExperimentRuntime(svc, "random", seed=0).run(
        ops, n_slices=1, amount=0.25, maintain_every=1, measure_damaged=True), main_launches)
    rec = run.records[0]
    base, dmg, rep = _pg(run.baseline), 100 * rec.damaged_percent_global, 100 * rec.percent_global
    say(f"phase 6: GIS 0.01 stress with DiDiC's kernel route: base {base:.4f}, damaged {dmg:.4f}, repaired "
        f"{rep:.4f} T_G %; launches {json.dumps(counts, sort_keys=True)}")
    check(counts["bell_matmul"] > 0, f"GIS 0.01 stress maintenance went through bell_matmul "
                                     f"({counts['bell_matmul']} launches)")
    check(dmg > base and rep < dmg, "GIS 0.01 stress on the kernel route: damaged > base, repaired < damaged")


def bf16_gaps(got, want, tile: int = 64):
    """How far a bfloat16 attention output ``got [H, T, Dh]`` lies from
    ``want``, the same function computed in float32 and rounded to
    bfloat16: whether every element is within atol 4e-3 + rtol 1.6e-2
    (two bfloat16 steps), the largest absolute gap, and the largest
    relative L2 gap of one (head, ``tile``-query tile)."""
    g, w = got.float(), want.float()
    close = bool(torch.allclose(g, w, rtol=1.6e-2, atol=4e-3))
    h, t, dh = w.shape
    gt, wt = g.reshape(h, t // tile, tile * dh), w.reshape(h, t // tile, tile * dh)
    tile_gap = float(((gt - wt).norm(dim=-1) / wt.norm(dim=-1).clamp_min(1e-30)).max())
    return close, float((g - w).abs().max()), tile_gap


def phase1_flash(dev, records):
    """``flash_attention`` at the JAX package's test shapes (float32 within
    2e-5, bfloat16 within 3e-2) and at granite-3-8b's prefill shape, where
    the bar is set by bfloat16 rounding of the output (``bf16_gaps``)."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ops import _ffma_bf16_uncounted
    from repro_torch.kernels.flash_attention.ref import TEST_SHAPES

    rng = np.random.default_rng(0)
    for b, hq, hkv, tq, tk, dh, causal, qoff in TEST_SHAPES:
        q, k, v = (torch.as_tensor(rng.normal(size=(b * h, t, dh)).astype(np.float32), device=dev)
                   for h, t in ((hq, tq), (hkv, tk), (hkv, tk)))
        got = flash_attention(q, k, v, causal=causal, q_offset=qoff)
        want = attention_ref(q, k, v, causal=causal, q_offset=qoff)
        check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
              f"flash_attention f32 B={b} Hq={hq} Hkv={hkv} Tq={tq} Tk={tk} Dh={dh} "
              f"causal={causal} q_offset={qoff}: within 2e-5")
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.bfloat16, device=dev)
               for s in ((4, 64, 32), (2, 64, 32), (2, 64, 32)))
    got = flash_attention(q, k, v).float()
    check(torch.allclose(got, attention_ref(q.float(), k.float(), v.float()), rtol=3e-2, atol=3e-2),
          "flash_attention bf16 [4x64x32] against float32 attention: within 3e-2")

    # The main path's shape: granite-3-8b prefill, B=1, Hq=32, Hkv=8, T=4096, Dh=128.
    hq, hkv, t, dh = 32, 8, 4096, 128
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((h, t, dh), generator=gen, device=dev).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    got = flash_attention(q, k, v)
    want = attention_ref(q, k, v)
    close, err, tile_gap = bf16_gaps(got, want)
    # Outputs here are ~0.03 (means of up to 4,096 unit values), so the
    # JAX tests' 3e-2 would be as large as the values themselves.
    check(close, f"flash_attention bf16 at granite's prefill shape [{hq}x{t}x{dh}], kv {hkv}: "
                 f"within atol 4e-3 + rtol 1.6e-2, two bf16 steps (max abs {err:.3g})")
    check(tile_gap <= 2.0 ** -7, f"flash_attention bf16 at granite's prefill shape: every (head, 64-query tile) "
                                 f"within a relative L2 gap of 2^-7, one bf16 step (largest {tile_gap:.3g})")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = q[None], k[None], v[None]
    lib_out = sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)[0]
    check(torch.allclose(lib_out.float(), want.float(), rtol=3e-2, atol=3e-2),
          "scaled_dot_product_attention agrees (yardstick)")
    # The previous design (the float32-pipe kernel, kept for float32) on the
    # same bfloat16 inputs, launched outside the counts.
    old = _ffma_bf16_uncounted(q, k, v)
    old_close, old_err, _ = bf16_gaps(old, want)
    check(old_close, f"the previous (ffma) design at granite's prefill shape: within two bf16 steps "
                     f"(max abs {old_err:.3g})")
    ms = time_cuda(lambda: flash_attention(q, k, v))[0]
    old_ms = time_cuda(lambda: _ffma_bf16_uncounted(q, k, v))[0]
    plain_ms = time_cuda(lambda: attention_ref(q, k, v), reps=5)[0]
    library_ms = time_cuda(lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True))[0]
    b2b_ms = time_cuda(lambda: flash_attention(q, k, v), inner=B2B)[0]
    library_b2b_ms = time_cuda(lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True), inner=B2B)[0]
    pairs = t * (t + 1) // 2                  # causal (query, key) pairs this call computes
    n_flops = 4.0 * hq * pairs * dh           # q.k and p.v, two operations a multiply-add
    n_bytes = (2 * hq + 2 * hkv) * t * dh * 2  # q, k, v read once, o written once, bf16
    b_ms, b_by = bound_ms(n_bytes, n_flops, PEAK_BF16_FLOPS)
    say(f"phase 1: flash_attention bf16 causal [{hq}x{t}x{dh}], kv {hkv}: kernel (wgmma) {ms:.4f} ms, "
        f"previous design (ffma) {old_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {n_flops / 1e9:.1f} GFLOP at 989 TFLOP/s); "
        f"kernel {n_flops / ms / 1e9:.1f} TFLOP/s, {100 * b_ms / ms:.1f} % of the bound, "
        f"{old_ms / ms:.2f}x the previous design; {B2B} calls back to back: kernel {b2b_ms:.4f} ms a call "
        f"({n_flops / b2b_ms / 1e9:.1f} TFLOP/s), scaled_dot_product_attention {library_b2b_ms:.4f} ms")
    records["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "max_abs_err": err, "ms": ms, "b2b_ms": b2b_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


def _embedding_bag_checks(dev, params, batch, records):
    """``embedding_bag`` at the JAX package's test shapes (within 1e-6) and
    at the main path's shape: DIN's item table, 262,144 bags of 100."""
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_auto, embedding_bag_ref
    from repro_torch.kernels.embedding_bag.ref import TEST_SHAPES

    rng = np.random.default_rng(3)
    for v, d, b, l in TEST_SHAPES:
        table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32), device=dev)
        idx = torch.as_tensor(rng.integers(0, v, size=(b, l)).astype(np.int32), device=dev)
        w = rng.random((b, l)).astype(np.float32)
        w[:, -1] = 0.0
        w = torch.as_tensor(w, device=dev)
        check(torch.allclose(embedding_bag(table, idx, w), embedding_bag_ref(table, idx, w),
                             rtol=1e-6, atol=1e-6), f"embedding_bag V={v} D={d} B={b} L={l}: within 1e-6")

    table, idx, mask = params["item_embed"], batch["hist_items"], batch["hist_mask"]
    w = mask / torch.clamp(mask.sum(dim=1, keepdim=True), min=1e-9)  # mean mode's weights
    got = embedding_bag_auto(table, idx, mask, mode="mean")
    want = embedding_bag_ref(table, idx, w)
    err = float((got - want).abs().max())
    b, l = idx.shape
    v, d = table.shape
    check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
          f"embedding_bag mean over DIN's item table [{v}x{d}], {b} bags of {l}: within 1e-6 (max {err:.3g})")
    check(torch.equal(embedding_bag(table, idx, w), embedding_bag(table, idx, w)),
          "embedding_bag at DIN's shape: two launches give the same bits")
    idx64 = idx.long()
    lib = torch.nn.functional.embedding_bag
    check(torch.allclose(lib(idx64, table, per_sample_weights=w, mode="sum"), want, rtol=1e-5, atol=1e-5),
          "torch.nn.functional.embedding_bag agrees (yardstick)")
    ms = time_cuda(lambda: embedding_bag(table, idx, w))[0]
    b2b_ms = time_cuda(lambda: embedding_bag(table, idx, w), inner=B2B)[0]
    plain_ms = time_cuda(lambda: embedding_bag_ref(table, idx, w), reps=5)[0]
    library_ms = time_cuda(lambda: lib(idx64, table, per_sample_weights=w, mode="sum"))[0]
    n_bytes = v * d * 4 + 2 * b * l * 4 + b * d * 4  # table, idx, w read once; out written once
    b_ms, b_by = bound_ms(n_bytes, 2.0 * b * l * d)
    gathered = b * l * d * 4
    say(f"phase 4: embedding_bag [{v}x{d}] table, {b}x{l} bags: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch embedding_bag {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB; "
        f"the gathered rows are {gathered / 1e9:.3f} GB, gathered at {gathered / ms / 1e6:.1f} GB/s); "
        f"{B2B} calls back to back: kernel {b2b_ms:.4f} ms a call ({gathered / b2b_ms / 1e6:.1f} GB/s)")
    records["embedding_bag"] = {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:39",
        "max_abs_err": err, "ms": ms, "b2b_ms": b2b_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


def phase4_din(dev, records, main_launches):
    """DIN at ``configs/din.FULL``: the catalogue's serve_bulk (262,144
    requests) and retrieval_cand (one user, 1,000,000 candidates) shapes.
    The ``user_vector`` call is the main path of ``embedding_bag``."""
    from repro_torch import kernels
    from repro_torch.configs.din import FULL
    from repro_torch.data.pipeline import din_batch
    from repro_torch.kernels.embedding_bag import embedding_bag_ref
    from repro_torch.models import recsys

    cfg = FULL
    n_req = 262_144
    params = recsys.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    host, host_s = once(lambda: din_batch(n_req, cfg.seq_len, cfg.n_items, cfg.n_cats, seed=0))
    batch = {k: torch.as_tensor(a, device=dev) for k, a in host.items()}
    say(f"phase 4: DIN {cfg.n_items} items, {cfg.n_cats} categories, width {cfg.embed_dim}, "
        f"history {cfg.seq_len}; batch of {n_req} made in {host_s:.2f} s")
    _embedding_bag_checks(dev, params, batch, records)

    small = {k: t[:512] for k, t in batch.items()}
    cpu_params = {k: ({n: x.cpu() for n, x in v.items()} if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    with torch.no_grad():
        on_card = recsys.forward(cfg, params, small).cpu()
        on_cpu = recsys.forward(cfg, cpu_params, {k: t.cpu() for k, t in small.items()})
        check(torch.allclose(on_card, on_cpu, rtol=1e-5, atol=1e-5),
              "DIN forward on the card == on the CPU, 512 requests, within 1e-5")

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        logits, score_s = once(lambda: recsys.forward(cfg, params, batch))
        score_launches = kernels.launch_counts()["embedding_bag"]
        score_peak = torch.cuda.max_memory_allocated()
        check(tuple(logits.shape) == (n_req,) and bool(torch.isfinite(logits).all()),
              f"DIN scores {n_req} requests: finite logits of shape [{n_req}]")
        check(score_launches == 0, "DIN scoring pools with softmax weights and launches no embedding_bag")
        loss = float(recsys.bce_loss(cfg, params, batch))
        check(np.isfinite(loss), f"DIN BCE loss {loss:.4f} is finite")

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        uv, uv_s = once(lambda: recsys.user_vector(cfg, params, batch))
        counts = kernels.launch_counts()
        _add_counts(main_launches, counts)
        uv_peak = torch.cuda.max_memory_allocated()
        check(counts["embedding_bag"] == 2, f"user_vector launched embedding_bag twice ({counts['embedding_bag']})")
        w = batch["hist_mask"] / torch.clamp(batch["hist_mask"].sum(dim=1, keepdim=True), min=1e-9)
        want = torch.cat([embedding_bag_ref(params["item_embed"], batch["hist_items"], w),
                          embedding_bag_ref(params["cat_embed"], batch["hist_cats"], w)], dim=-1)
        check(tuple(uv.shape) == (n_req, 2 * cfg.embed_dim) and torch.allclose(uv, want, rtol=1e-6, atol=1e-6),
              f"user_vector [{n_req}x{2 * cfg.embed_dim}] == plain pooling within 1e-6")

        cand = torch.arange(1_000_000, device=dev) % cfg.n_items
        recsys.retrieval_scores(cfg, params, uv[:1], cand, cand % cfg.n_cats)  # warm-up
        scores, retr_s = once(lambda: recsys.retrieval_scores(cfg, params, uv[:1], cand, cand % cfg.n_cats))
        check(tuple(scores.shape) == (1, 1_000_000) and bool(torch.isfinite(scores).all()),
              "retrieval: one user against 1,000,000 candidates, finite scores")
    say(json.dumps({
        "phase": 4, "model": cfg.name, "requests": n_req,
        "score_s": score_s, "requests_per_s": n_req / score_s, "score_peak_device_bytes": score_peak,
        "user_vector_s": uv_s, "user_vectors_per_s": n_req / uv_s, "user_vector_peak_device_bytes": uv_peak,
        "retrieval_1x1M_s": retr_s, "bce_loss": loss, "embedding_bag_launches_in_user_vector": 2,
        "embedding_bag_launches_in_scoring": score_launches,
    }))


def phase5_lm(dev, main_launches):
    """granite-3-8b at ``configs/granite_3_8b.FULL``, all 40 layers, random
    bf16 weights: forward and loss over 4,096 tokens (the ``flash_attention``
    main path), then the server on 8 requests, twice."""
    from repro_torch import kernels
    from repro_torch.configs.granite_3_8b import FULL
    from repro_torch.data.pipeline import LmDataConfig, lm_token_stream
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = FULL
    params, init_s = once(lambda: tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = sum(t.numel() for t in (params["embed"], params["lm_head"], params["ln_f"]["scale"]))
    n_params += sum(t.numel() for leaves in params["layers"].values() for t in leaves.values())
    check(n_params == cfg.param_count(), f"granite-3-8b: {n_params:,} parameters drawn on the card in {init_s:.2f} s")

    with torch.no_grad():
        # Prefill (through flash_attention) against decode (the cache path)
        # on 16 tokens: the same causal function, so the logits agree to
        # bf16 rounding over 40 layers.
        toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, size=(1, 16)), device=dev)
        pre, _ = tf.forward(cfg, params, toks)
        cache = tf.init_kv_cache(cfg, 1, 16, device=dev)
        dec = torch.stack([tf.serve_step(cfg, params, toks[:, t], cache, t)[0] for t in range(16)], dim=1)
        rel = float((pre.float() - dec.float()).norm() / dec.float().norm())
        check(bool(torch.isfinite(pre).all()) and rel < 0.1,
              f"granite prefill == token-by-token decode on 16 tokens: relative L2 gap {rel:.4f} < 0.1")

        batch = next(lm_token_stream(LmDataConfig(vocab=cfg.vocab, seq_len=4096, batch=1, seed=0)))
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        (logits, _), fwd_s = once(lambda: tf.forward(cfg, params, tokens))
        counts = kernels.launch_counts()
        _add_counts(main_launches, counts)
        fwd_peak = torch.cuda.max_memory_allocated()
        routes = dict(kernels.KERNELS["flash_attention"].route_launches)
        check(counts["flash_attention"] == cfg.n_layers,
              f"granite forward over 4096 tokens launched flash_attention {counts['flash_attention']} times "
              f"(one a layer)")
        check(routes == {"wgmma": cfg.n_layers},
              f"every flash_attention launch of the granite forward took the tensor-core route ({routes})")
        check(tuple(logits.shape) == (1, 4096, cfg.vocab) and bool(torch.isfinite(logits).all()),
              f"granite logits [1x4096x{cfg.vocab}] are finite")
        del logits
        _, fwd2_s = once(lambda: tf.forward(cfg, params, tokens))
        loss, loss_s = once(lambda: float(tf.loss_fn(cfg, params, {"tokens": tokens, "labels": labels})))
        check(np.isfinite(loss), f"granite loss {loss:.4f} is finite (ln V = {np.log(cfg.vocab):.4f})")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(2, 8)) for _ in range(8)]
    runs = []
    for _ in range(2):
        eng = ServingEngine(cfg, params, batch_slots=4, max_len=128, device=dev)
        reqs = [Request(prompt=p.copy(), max_new_tokens=16) for p in prompts]
        for r in reqs:
            eng.submit(r)
        kernels.reset_launch_counts()
        _, serve_s = once(eng.run_until_drained)
        flash = kernels.launch_counts()["flash_attention"]
        check(all(r.done and len(r.generated) == 16 for r in reqs),
              f"granite server answered all 8 requests, 16 tokens each ({serve_s:.2f} s)")
        check(flash == 0, "the server decodes through the cache path and launches no flash_attention")
        runs.append(([r.generated for r in reqs], serve_s))
        del eng
    check(runs[0][0] == runs[1][0], "granite server: two runs give the same tokens")
    n_tok = sum(len(g) for g in runs[0][0])
    n_prompt = sum(len(p) for p in prompts)
    say(json.dumps({
        "phase": 5, "model": cfg.name, "parameters": n_params, "init_s": init_s,
        "forward_tokens": 4096, "forward_first_s": fwd_s, "forward_s": fwd2_s,
        "forward_tokens_per_s": 4096 / fwd2_s, "forward_peak_device_bytes": fwd_peak,
        "loss": loss, "loss_s": loss_s, "flash_attention_launches_per_forward": counts["flash_attention"],
        "serve_requests": 8, "serve_prompt_tokens": n_prompt, "serve_new_tokens": n_tok,
        "serve_s": [r[1] for r in runs], "serve_new_tokens_per_s": [n_tok / r[1] for r in runs],
        "prefill_decode_rel_gap": rel,
    }))


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
    phase1_flash(dev, records)
    say(f"phase 1 done at {time.perf_counter() - t_start:.1f} s")

    main_launches = {}
    starts = {}
    for name, graph in graphs.items():
        starts[name] = phase2_dataset(name, graph, dev, main_launches)
        say(f"phase 2 {name} done at {time.perf_counter() - t_start:.1f} s")
    gis_small, kernel_parts = phase3(dev, main_launches)
    say(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    for name, graph in graphs.items():
        phase6_dataset(name, graph, starts[name], dev, main_launches)
        say(f"phase 6 {name} done at {time.perf_counter() - t_start:.1f} s")
    phase6_bell(gis_small, kernel_parts, dev, main_launches)
    say(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")
    del graphs, starts, gis_small
    torch.cuda.empty_cache()
    phase4_din(dev, records, main_launches)
    torch.cuda.empty_cache()
    say(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
    phase5_lm(dev, main_launches)
    say(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
    say("main-path launches (the replays of phase 2, the kernel-route DiDiC of phase 3, "
        "user_vector in phase 4, the granite forward in phase 5, the replays and maintenance of "
        "phase 6): " + json.dumps(main_launches, sort_keys=True))
    for name in KERNEL_ORDER:
        n = main_launches.get(name, 0)
        check(n > 0, f"{name} launched on the main path ({n} times)")
        records[name]["launches"] = n

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: records[n][k] for k in keys} for n in KERNEL_ORDER]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
