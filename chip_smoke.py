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
   DiDiC's matrix must give the same bits; ``flash_attention`` also at the
   other LM configs' prefill groups (Hq/Hkv 56/8, 32/4, 16/16; T 4,096, Dh
   128, bf16) against its plain version and beside SDPA; and its backward,
   the hand-written ``flash_attention_bwd``, against the plain o/lse
   backward at the JAX tests' shapes (float32 within 1e-5, bfloat16 3e-2),
   at those groups and at granite's prefill shape, two calls bit-equal, the
   ``autograd.Function`` at granite's shape against autograd through the
   plain version, forward plus backward and the backward alone timed beside
   SDPA's; ``segment_sum`` at the halo products' shapes (the distributed
   GCN's on GIS, F = 32; the Twitter mesh DiDiC's, F = 4) equal to its
   plain version on the CPU bit for bit, two launches bit-equal, timed
   beside ``index_add_`` (its device time a call by ``torch.profiler``), and
   on Twitter's hub alone beside the hub's chain floor; ``segment_spmm`` at
   DiDiC's coefficient matrices at ``scale=1.0`` (k = 4) equal to its plain
   version on the CPU bit for bit, two launches bit-equal, timed beside
   ``torch.sparse.mm`` on CSR (cuSPARSE), each of DiDiC's three updates as
   its epilogue checked and timed beside the bare product, Twitter's hub
   alone beside its chain floor, k = 2 and 8 on GIS, and the capacity
   overlay's dead rows;
2. the main path at the paper's scale (filesystem, GIS, Twitter at
   ``scale=1.0``, k=4): random, hard-coded and DiDiC partitions, the
   paper's 10 000-op evaluation log replayed through the service on the
   card, exactness of the batched engine against the scalar oracle on
   the first 64 ops, DiDiC's run-to-run determinism, every DiDiC product
   one ``segment_spmm`` launch with its update as the epilogue (counted by
   epilogue), and 2 iterations with the updates fused against 2 with the
   eager updates around a bare product, bit-equal;
3. DiDiC's ``bell_matmul`` route on GIS at ``scale=0.01`` beside its
   ``segment_spmm`` route;
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
   Twitter twice), Insert with vertex growth (4 slices, 30 % inserts; its
   first growth slice attaches a delta-overlay store, every grown graph is
   adopted by the store's engine and DiDiC tables, each adoption and table
   re-pad timed beside a fresh engine's build) and the maintenance cost;
   GIS replays a 500-op log here;
7. the hot-vertex placement and the paper's tables, run after phase 6:
   (a) at ``scale=1.0``, k=4, from phase 2's DiDiC maps, a service with an
   exception table of 128 replays each dataset's log (GIS: phase 6's
   500 ops), re-selects its hot vertices (``refresh_placement``) and
   replays again, beside capacities 8 and 32: totals conserved, T_G % never
   higher, and on GIS the masked replay equal to the scalar oracle on 64
   ops; (b) ``repro_torch.skew_smoke`` at the JAX package's parameters,
   with its gates; (c) ``repro_torch.paper_tables`` at ``scale=0.01``,
   DiDiC 20 iterations: every table's row names, finite values, and DiDiC
   below random on every dataset;
8. the fault layer, run after phase 7 at ``scale=1.0`` from phase 2's
   DiDiC maps and states: (a) on each dataset, ``run_with_recovery`` (4
   slices of 5 %, 20 % inserts, maintenance every 3rd slice, snapshots
   every 3rd round-tripped through their bytes) under a pre-commit crash,
   two maintenance timeouts and a post-commit crash, bit-exact against an
   uninterrupted run, with 2 recoveries, 2 retries and a peak device memory
   within 10 % of the uninterrupted run's (both legs grow through one
   store); (b) the online server on GIS
   (40 ``gis_short``/``gis_long`` requests under each arrival process, 8-slot
   batches, a 64-op queue, background DiDiC every 8 ticks, SLOs of 8 and 16
   ticks), a clean leg and a leg with an admit and a commit crash, equal to
   each other and to the offline replay of their epochs; (c) the same
   with 128 replicas on filesystem plus a parking vertex, ``filesystem``
   and ``twitter`` clients with ``skewed_hot`` arrivals;
9. after phase 5, the other four LM configs at full width and depth, random
   bf16 weights, one at a time (each freed before the next is drawn, less
   than 2 GB allocated before each draw): deepseek-moe-16b,
   qwen3-moe-30b-a3b, deepseek-coder-33b, yi-34b, each as phase 5 runs
   granite (parameter count; prefill against decode on 16 tokens, for an
   MoE config at a capacity where nothing drops; forward and loss over
   4,096 tokens with one ``flash_attention`` launch a layer on the
   tensor-core route; the server twice); for the MoE configs also the
   share of assignments dropped at capacity factor 1.25, DiDiC expert
   placement from layer 0's and the last layer's router choices
   (co-location against the naive groups, a balanced permutation), and
   ``moe_fwd`` alone at ``[1, 4096, d_model]`` against its bound;
10. after phase 9, training: (a) granite-3-8b at full width, bf16, depth
    cut to the largest of 16, 12 and 8 layers whose step peaks under 76
    GB (one step each at 4 and 8 layers measures the peak's line), the
    port's ``Trainer`` for 5 steps on one 4,096-token sequence repeated,
    then one step split into forward, backward and update by CUDA events,
    with every gradient finite and wq, wk, wv non-zero in every layer;
    (b) ``launch.train`` for the five LM archs and DIN, 20 steps with a
    checkpoint directory under ``build/`` and a fault at step 10, on the
    card and on the CPU, whose losses the card's must equal;
11. after phase 10, the GNNs and MACE: (a) gcn-cora, graphsage-reddit,
    meshgraphnet and mace at their ``FULL`` widths, random weights drawn on
    the CPU, on cora_like (2,708 nodes), reddit_like (232,965 nodes, its
    features resident on the card), a 64x64 mesh and 128 molecules, labels
    from a DiDiC partition run on the card: one forward held to the CPU and,
    bit for bit, to a second card run (graphsage-reddit sampled through
    ``NeighborSampler((15, 10))`` on 1,024 nodes, and its full graph once;
    its sampled block's gather backward also as a ``segment_sum`` check),
    MACE's energies under a rotation, then 5 trainer steps whose loss must
    fall, every sum through ``segment_sum`` and no other kernel launched;
    (b) ``launch.train`` for the four archs as in 10b, and the faulted card
    run bit-equal to an uninterrupted card run (every logged loss and the
    final parameters);
12. after phase 11, the partitioned service on a process group: an NCCL
    group of one rank on the card, from phase 2's DiDiC maps at
    ``scale=1.0`` (the graphs kept as host arrays): cold sharded replays of
    filesystem's and Twitter's 10,000-op logs bit-equal to the batched
    results phase 2 held, and of GIS's phase-6 log (500 ops)
    (per-op counters equal to phase 6's, all four to a batched replay),
    through ``frontier_gather``; on GIS the resident fold against the
    random map and one structural slice with a partial redo, bit-equal to
    a cold batched replay of the grown graph; degraded mode (shard 0
    failed); the halo-exchange DiDiC on Twitter against random and the
    single-device run, run twice with bit-equal ``parts`` and ``w``; the device-scan ``least_traffic`` log against the
    host's; two mesh-runtime slices on Twitter against the meshless
    runtime;
13. after phase 12, the model side of multi-device on an NCCL group of one
    rank, a ``("data", "model")`` mesh of (1, 1) (past 1,050 s by the
    script's clock it cuts its own depth: (a)'s ranks play the first and
    the last layer, (c) runs 20 steps): (a) deepseek-moe-16b at full width
    and depth (random bf16 weights), placed by ``shard_tree`` with
    ``lm_param_specs`` (the JAX layout), its forward on the mesh (attention
    tensor parallel, the MoE expert parallel) over 4,096 tokens bit-equal to
    the dense forward (28 ``flash_attention`` launches on ``wgmma``), and
    each layer's MoE played as 4 model ranks in turn (16 experts and a
    quarter of the shared expert's columns each), their parts summed
    against ``moe_fwd``; (b) the online server on GIS at ``scale=1.0`` on a mesh
    service (``maintenance="shared"``) from phase 2's DiDiC map, a clean and
    a crash leg (admit and commit crashes, shard 0 failed for 4 ticks) of 40
    requests, each equal to the offline replay of its epochs and to the
    other, with no resident state left; (c) the distributed GCN twin on
    GIS at ``scale=1.0`` folded onto the one shard, 60 steps, run again with
    every loss bit-equal, its first 5 losses against the same run on the CPU
    (a gloo group of one rank);
14. after phase 13, the capacity store on the card (budget 40 s; past
    1,050 s by the script's clock it cuts its own GIS slices): (a) on
    filesystem at ``scale=1.0`` a store filled exactly is carried and one
    more growth log compacts, each grown graph's replay equal to a fresh
    storeless engine's and to the scalar oracle on 64 ops; (b) a crash at
    ``apply:compact`` in a 3-slice growth run on Twitter with tiny headroom,
    recovered bit-exact against the uninterrupted run; (c) GIS at ``scale=1.0``, 4
    growth slices within capacity: one engine object, its capacity buffers
    never reallocated, ``frontier_gather`` on every replay, each adoption
    timed beside a rebuild; (d) on an NCCL group of one rank, Twitter's
    sharded maintenance before and after growth through one capacity mesh
    program, its T_G % in the band of the single-device overlay refine;
15. after phase 14, the expert-parallel training step (budget 30 s; past
    1,050 s by the script's clock its depth is cut to 2, unprobed): the
    config registry's ``train_4k`` cell of qwen3-moe-30b-a3b at full width
    (bf16), its step built by ``base.lm_dryrun`` on an NCCL group of one
    rank, a (1, 1) ``HostMesh``; depth cut to the largest of 6..2 layers
    whose step peaks within 70 GB (one step each at 1 and 2 layers gives the
    peak's line), the global batch of 256 cut to one 4,096-token sequence,
    AdamW at phase 10's lr without warm-up: (a) step 1's loss and every
    gradient leaf, then 3 steps' losses and final parameters, bit-equal to
    the dense step's, the loss falling; (b) one layer's MoE backward played
    as 4 model ranks in turn (32 experts each), each rank's expert gradients
    against the dense slices and the partial router and x gradients summed
    once against the dense ones, within one bf16 step; (c) the same cell
    built on ``meta`` by the registry, its output shapes equal to the
    card's and its FLOPs counted there;
16. after phase 15, repro-lint over the port (budget 10 s; past 1,100 s
    by the script's clock (b) runs 5 slices): (a) ``run_lint`` over
    ``src/repro_torch`` against its baseline, no new finding (host work);
    (b) the rebuild sentinel at its defaults (filesystem at ``scale=0.002``,
    20 slices of 5 %, insert rate 0.5, DiDiC every 6 slices) on an NCCL
    group of one rank: the service and its engine's and replayer's
    tensors on ``cuda``, the graph grown, slice 0 building the store's
    engine and replayer, no rebuild after warm-up, steady state, no
    finding; each slice's seconds and DiDiC table refreshes printed;
17. after phase 16, the JAX layout's tensor-parallel LM (budget 30 s; past
    1,050 s by the script's clock (a) trains 1 layer): (a) granite-3-8b's
    ``train_4k`` step from the registry at full width, 2 layers, one
    4,096-token sequence, on an NCCL group of one rank, a (1, 1) mesh
    (vocabulary-parallel embedding and cross-entropy, tensor-parallel
    attention and SwiGLU, remat as the JAX config sets it): its loss, every
    gradient and the updated parameters bit-equal to the dense step, the
    gradients bit-equal to the step without remat, one ``wgmma``
    ``flash_attention`` launch a layer in the forward and one in remat's
    recompute; (b) one granite layer as 4 model ranks played in turn (8 q
    heads, 2 kv heads, 3,200 FFN columns and 12,320 vocabulary rows a
    rank), every collective replayed from the ranks' parts: the output and
    the gradients in x and every shard against the dense layer, the
    embedding bit-equal, the vocabulary-parallel cross-entropy against the
    dense loss; (c) yi-34b's attention as 16 model ranks (3.5 q heads of
    ``wo`` rows a rank, q gathered), 16 ``wgmma`` launches, the summed parts
    against the dense attention; (d) granite's decode attention against a
    32,768-position cache split over 16 model ranks (split-K, log-sum-exp
    combine) against the dense ``decode_attention``;
18. after phase 17, the paper's Stress and Dynamic tables on a mesh
    (budget 30 s; past 1,050 s by the script's clock it runs Twitter only):
    ``PaperBench`` at ``scale=1.0``, k=4, on Twitter and GIS, its caches
    seeded with phase 2's graphs, DiDiC maps and states and phase 6's logs
    (10,000 and 500 ops), on an NCCL group of one rank: (a) the Stress
    table with ``maintenance="shared"`` (sharded replay, device-scan
    dynamism, the single-device DiDiC), its base, damaged and repaired rows
    equal to the figures phase 6 measured, rounded as the table rounds
    them; (b) the Dynamic table with the mesh DiDiC (``"auto"``): the row
    names, each round's T_G % within ``0.25·ref + 0.01`` of phase 6's
    maintained round, round 5 below phase 6's unmaintained map, and
    ``cycle_s`` beside phase 6's meshless seconds; run twice, every round,
    the last slice's counters, the final map and the carried ``w``
    bit-equal. Phase 0 also times a
    fixed host-only workload, to read the script's time against.

Each kernel's ``launches`` come from its main-path runs: each replay of
phase 2 (``frontier_gather``), its DiDiC runs and every single-device
DiDiC run inside a counted run after them (``segment_spmm``), the
kernel-route DiDiC run of phase 3
(``bell_matmul``), the ``user_vector`` call of phase 4 (``embedding_bag``),
the granite forward call of phase 5, the four forward calls of phase 9
and phase 10's trainer runs on the card
(``flash_attention``; the trainer runs' backwards ``flash_attention_bwd``), every replay
and maintenance run of phase 6 (``frontier_gather``, ``bell_matmul``),
phase 7's replays and tables, phase 8's uninterrupted, recovered and
online runs, phase 12's sharded GIS replays, phase 13's online runs and
phase 14's replays and runs and phase 18's tables (``frontier_gather``),
and phase 13's mesh forward, phase 15's EP training steps and phase 17's
TP training step and model ranks' attention (``flash_attention``; the
training steps' backwards ``flash_attention_bwd``), and phase 11's trainer
steps, phase 12's halo DiDiC runs, phase 13's GCN run and phase 18's
Dynamic tables (``segment_sum``);
phase 8's offline replays, the reference
the online runs are checked against, are read apart and not counted.
Phase 16's launches are not counted (its BFS replays reach no kernel; its
DiDiC passes go through ``segment_spmm``). The
launch counts are set to 0 just before each of them and read just after. Each
kernel's ``ms`` is one call between two CUDA events, its wrapper's host
work included; its phase line also gives its time a call over 10 calls
back to back, where the host enqueues the next call while the card runs.

It prints one line per check, then a JSON line with every kernel's
record, the ``nvidia-smi`` name and power-limit line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is not 0 and the last line is never printed. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
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
KERNEL_ORDER = ("frontier_gather", "bell_matmul", "embedding_bag", "flash_attention", "flash_attention_bwd",
                "segment_sum", "segment_spmm")


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
    say(f"phase 0: host speed: {_host_workload_s():.4f} s for a fixed host-only workload (numpy: 3 sorts "
        f"of 2^22 float64, 2,000,000 Python loop steps); a script time is read against it")
    return smi


def _host_workload_s() -> float:
    """Seconds of a fixed host-only workload: numpy sorts and a Python loop,
    the two kinds of host work that pace the replays (no card, no torch)."""
    a = np.random.default_rng(0).random(1 << 22)
    t0 = time.perf_counter()
    for _ in range(3):
        np.sort(a)
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    return time.perf_counter() - t0


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


def _bits_equal(a, b) -> bool:
    """Same shape, dtype and bytes (NaN and the sign of zero included)."""
    a, b = torch.as_tensor(a).detach().cpu(), torch.as_tensor(b).detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(ints), b.contiguous().view(ints)
    return bool(torch.equal(a, b))


def _device_ms_per_call(call, kernel: str, calls: int = B2B):
    """Device milliseconds a call of ``call`` spends in the CUDA kernels
    whose name holds ``kernel``, by ``torch.profiler`` over ``calls`` calls
    back to back; None when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key)
    return total / 1e3 / calls if total > 0 else None


def segment_sum_case(data, ids, n, what, dev):
    """``segment_sum`` on ``data [E, F]`` (on the card) over ``ids``: equal
    to its plain version run on the CPU bit for bit, two launches bit-equal;
    timed single and back to back, its device time a call by
    ``torch.profiler`` beside them, the plain version on the card and
    ``index_add_`` (the library call: the same function, by atomics), the
    grouping's one-off build timed apart. Returns the record's numbers."""
    from repro_torch.kernels.segment_sum import segment_order_ref, segment_sum, segment_sum_ref

    e, f = data.shape
    ids = ids.reshape(-1)
    order_ms = time_cuda(lambda: segment_order_ref(ids, n), reps=5)[0]
    got = segment_sum(data, ids, n)
    want = segment_sum_ref(data.cpu(), ids.cpu().long(), n)
    check(_bits_equal(got, want), f"segment_sum {what} [{e:,}x{f}] into {n:,} rows: the card == the plain "
                                  f"version on the CPU, bit for bit")
    check(_bits_equal(got, segment_sum(data, ids, n)), f"segment_sum {what}: two launches give the same bits")
    ids64 = ids.long()
    ms = time_cuda(lambda: segment_sum(data, ids, n))[0]
    b2b_ms = time_cuda(lambda: segment_sum(data, ids, n), inner=B2B)[0]
    device_ms = _device_ms_per_call(lambda: segment_sum(data, ids, n), "segment_sum")
    plain_ms = time_cuda(lambda: segment_sum_ref(data, ids64, n), reps=5)[0]
    library_ms = time_cuda(lambda: torch.zeros((n, f), device=dev).index_add_(0, ids, data))[0]
    library_b2b_ms = time_cuda(lambda: torch.zeros((n, f), device=dev).index_add_(0, ids, data), inner=B2B)[0]
    n_bytes = e * f * 4 + e * 8 + (n + 1) * 8 + n * f * 4   # data, perm, offsets read once; out written once
    b_ms, b_by = bound_ms(n_bytes, float(e * f))
    device = "not seen by the profiler" if device_ms is None else f"{device_ms:.4f} ms"
    say(f"segment_sum {what} [{e:,}x{f}] into {n:,} rows: kernel {ms:.4f} ms, {b2b_ms:.4f} b2b "
        f"({100 * b_ms / b2b_ms:.1f} % of the bound), device time a call (torch.profiler) {device}; plain "
        f"(index_add_ into zeros, by atomics) {plain_ms:.4f} ms; index_add_ {library_ms:.4f} ms, "
        f"{library_b2b_ms:.4f} b2b; bound {b_ms:.4f} ms ({b_by}); the grouping's build (stable sort, "
        f"offsets, long segments sorted) {order_ms:.4f} ms")
    return {"max_abs_err": float((got.cpu() - want).abs().max()), "ms": ms, "b2b_ms": b2b_ms,
            "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "library_b2b_ms": library_b2b_ms, "order_ms": order_ms, "shape": [e, f, n]}


def _smi_clocks():
    """The SM clock now and its maximum, MHz, as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    now, top = (float(x) for x in out.split(","))
    return now, top


def segment_sum_hub(data, ids, n, whole, dev):
    """Does the hub set the pace? ``segment_sum`` on the longest segment's
    rows alone (in edge order, one segment), bit-equal to the plain version
    on the CPU, timed as the whole product is, beside the whole product's
    time, its bytes bound and the hub's chain floor: its length times the
    cycles of one dependent add (measured on the card by the kernel's probe)
    over the top SM clock that ``nvidia-smi`` reports."""
    from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref
    from repro_torch.kernels.segment_sum.ops import add_cycles

    counts = torch.bincount(ids.reshape(-1).long(), minlength=n)
    hub = int(torch.argmax(counts))
    rows = data[ids.reshape(-1) == hub]
    zeros = torch.zeros(rows.shape[0], dtype=ids.dtype, device=dev)
    got = segment_sum(rows, zeros, 1)
    check(_bits_equal(got, segment_sum_ref(rows.cpu(), zeros.cpu().long(), 1)),
          f"segment_sum on the hub alone ({rows.shape[0]:,} edges): the card == the plain version on the CPU")
    ms = time_cuda(lambda: segment_sum(rows, zeros, 1))[0]
    b2b_ms = time_cuda(lambda: segment_sum(rows, zeros, 1), inner=B2B)[0]
    clock_now, clock_top = _smi_clocks()
    cycles, ns = add_cycles(dev)
    floor_ms = rows.shape[0] * cycles / (clock_top * 1e6) * 1e3
    say(f"segment_sum hub alone (segment {hub}, {rows.shape[0]:,} edges x {rows.shape[1]}): {ms:.4f} ms, "
        f"{b2b_ms:.4f} b2b, against the whole product's {whole['b2b_ms']:.4f} b2b (bytes bound "
        f"{whole['bound_ms']:.4f} ms); one dependent add {cycles:.3f} cycles ({ns:.4f} ns, the probe's clock "
        f"{cycles / ns * 1e3:.0f} MHz); SM clock {clock_now:.0f} MHz now, {clock_top:.0f} MHz top; chain floor "
        f"{floor_ms:.4f} ms ({rows.shape[0]:,} x {cycles:.3f} cycles at {clock_top:.0f} MHz)")
    return {"segment": hub, "edges": int(rows.shape[0]), "ms": ms, "b2b_ms": b2b_ms, "add_cycles": cycles,
            "add_ns": ns, "sm_clock_mhz": clock_now, "sm_clock_max_mhz": clock_top, "chain_floor_ms": floor_ms}


def phase1_segment_sum(dev, graphs, records):
    """``segment_sum`` at the halo products' shapes: the distributed GCN's
    on GIS (phase 13 (c): one shard, every undirected edge, F = 32) and the
    Twitter mesh DiDiC's (phases 12 (d) and 18 (b): F = k = 4), the edges
    as the graph lists them and random features (seed 5); Twitter's hub
    also alone; the sampled GraphSAGE block is checked in phase 11. Held
    bit for bit to the plain version on the CPU. The GIS case is the
    record's timed shape."""
    rng = np.random.default_rng(5)
    out = {}
    for name, f in (("twitter", 4), ("gis", 32)):
        g = graphs[name]
        s, r, w = g.undirected
        x = torch.as_tensor(rng.standard_normal((g.n_nodes, f)).astype(np.float32), device=dev)
        data = torch.as_tensor(w, dtype=torch.float32, device=dev)[:, None] * x[torch.as_tensor(s, device=dev).long()]
        ids = torch.as_tensor(r, device=dev)
        what = "the GIS halo product (distributed GCN)" if name == "gis" else "the Twitter mesh DiDiC's product"
        out[name] = segment_sum_case(data, ids, g.n_nodes, what, dev)
        if name == "twitter":
            out[name]["hub"] = segment_sum_hub(data, ids, g.n_nodes, out[name], dev)
    records["segment_sum"] = {
        "name": "segment_sum", "route": "cuda", "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "none: jax.ops.segment_sum (XLA scatter-add), src/repro/distributed/halo.py:181 and "
                    "src/repro/models/gnn.py:83",
        **out["gis"], "twitter": out["twitter"],
    }


def _spmm_check(spmm, x, what):
    """``segment_spmm`` with DiDiC's CSR matrix (a ``SegmentSpmm``'s) on
    ``x`` on the card: equal to its plain version on the CPU bit for bit,
    two launches bit-equal. Returns the card's product and the CPU's."""
    from repro_torch.kernels.segment_spmm import segment_spmm, segment_spmm_ref

    a = spmm.a
    got = segment_spmm(x, a)
    want = segment_spmm_ref(x.cpu(), a.col.cpu(), a.scale.cpu(), a.ids.cpu(), a.n)
    shape = f"[{a.col.numel():,} edges x {x.shape[1]}] into {a.n:,} rows"
    check(_bits_equal(got, want), f"segment_spmm {what} {shape}: the card == the plain version on the CPU, bit for bit")
    check(_bits_equal(got, segment_spmm(x, a)), f"segment_spmm {what}: two launches give the same bits")
    return got, want


def segment_spmm_case(spmm, x, what):
    """``_spmm_check``, then timed single and back to back, its device time
    a call by ``torch.profiler`` beside them, the plain version on the card,
    and the library call for the same function: ``torch.sparse.mm`` of the
    coefficients as a ``torch.sparse_csr_tensor`` (cuSPARSE), held to the
    plain version within 1e-4 (it sums in its own order). Returns the
    record's numbers."""
    from repro_torch.kernels.segment_spmm import segment_spmm, segment_spmm_ref

    a = spmm.a
    e, f, n = a.col.numel(), x.shape[1], a.n
    got, want = _spmm_check(spmm, x, what)
    call = lambda: segment_spmm(x, a)
    ms = time_cuda(call)[0]
    b2b_ms = time_cuda(call, inner=B2B)[0]
    device_ms = _device_ms_per_call(call, "segment_spmm")
    plain_ms = time_cuda(lambda: segment_spmm_ref(x, a.col, a.scale, a.ids, n), reps=5)[0]
    lib = torch.sparse_csr_tensor(a.offsets.long(), a.col.long(), a.scale, size=(n, x.shape[0]), check_invariants=True)
    check(torch.allclose(torch.sparse.mm(lib, x).cpu(), want, rtol=1e-4, atol=1e-4),
          f"segment_spmm {what}: cuSPARSE's CSR product agrees within 1e-4 (yardstick)")
    library_ms = time_cuda(lambda: torch.sparse.mm(lib, x))[0]
    library_b2b_ms = time_cuda(lambda: torch.sparse.mm(lib, x), inner=B2B)[0]
    # col and scale read once, x once, the offsets once; out written once
    n_bytes = e * 4 + e * 4 + x.numel() * 4 + (n + 1) * a.offsets.element_size() + n * f * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * e * f)
    device = "not seen by the profiler" if device_ms is None else f"{device_ms:.4f} ms"
    say(f"segment_spmm {what} [{e:,} edges x {f}] into {n:,} rows: kernel {ms:.4f} ms, {b2b_ms:.4f} b2b "
        f"({100 * b_ms / b2b_ms:.1f} % of the bound), device time a call (torch.profiler) {device}; plain "
        f"(products, then index_add_ into zeros) {plain_ms:.4f} ms; torch.sparse.mm on CSR (cuSPARSE) "
        f"{library_ms:.4f} ms, {library_b2b_ms:.4f} b2b; bound {b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB)")
    return {"max_abs_err": float((got.cpu() - want).abs().max()), "ms": ms, "b2b_ms": b2b_ms,
            "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "library_b2b_ms": library_b2b_ms, "shape": [e, f, n], "n_bytes": n_bytes}


def _epilogue_calls(a, x, degc, live, rng):
    """DiDiC's three updates fused with the product of ``a`` on ``x`` (an
    ``[n, k]`` tensor on the card), their operands drawn from ``rng`` beside
    ``degc``: {epilogue: (call on the card, call on the CPU, the operands'
    extra bytes: read once, the second output written once)}."""
    from repro_torch.core.didic import _BENEFIT
    from repro_torch.kernels.segment_spmm import segment_spmm_primary, segment_spmm_secondary, segment_spmm_smooth

    n, k = x.shape
    l = torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32), device=x.device)
    parts = torch.as_tensor(rng.integers(0, k, n).astype(np.int32), device=x.device)
    if live is not None:
        x, l = x * live[:, None], l * live[:, None]
    safe = torch.clamp(degc, min=1e-6)
    cpu_a = a._replace(ids=a.ids.cpu(), col=a.col.cpu(), scale=a.scale.cpu())
    host = {"x": x.cpu(), "l": l.cpu(), "degc": degc.cpu(), "parts": parts.cpu(), "safe": safe.cpu(),
            "live": None if live is None else live.cpu()}
    card = {"x": x, "l": l, "degc": degc, "parts": parts, "safe": safe, "live": live}
    sec = lambda m, t: segment_spmm_secondary(t["x"], m, t["l"], t["degc"], t["parts"], _BENEFIT, t["live"])
    pri = lambda m, t: segment_spmm_primary(t["x"], m, t["l"], t["degc"])
    smo = lambda m, t: segment_spmm_smooth(t["x"], m, t["safe"])
    rows = n * k * 4
    extra = {"secondary": 2 * rows + 8 * n + (0 if live is None else n), "primary": rows + 4 * n, "smooth": 4 * n}
    return {name: (lambda fn=fn: fn(a, card), lambda fn=fn: fn(cpu_a, host), extra[name])
            for name, fn in (("secondary", sec), ("primary", pri), ("smooth", smo))}


def _flat(out):
    """An epilogue's result as one tensor (secondary's two stacked)."""
    return torch.stack(out) if isinstance(out, tuple) else out


def segment_spmm_epilogues(spmm, x, degc, what, bare, live=None, timed=True):
    """Each epilogue (DiDiC's secondary, primary and smoothing updates
    fused with the product) on the card equal to its plain version on the
    CPU bit for bit, two launches bit-equal; with ``timed``, timed as the
    bare product is (single, b2b, device time) beside its bytes bound: the
    bare product's bytes and the epilogue's operands. Returns
    {epilogue: numbers}."""
    rng = np.random.default_rng(6)
    out = {}
    for name, (card, cpu, extra) in _epilogue_calls(spmm.a, x, degc, live, rng).items():
        got, want = _flat(card()), _flat(cpu())
        check(_bits_equal(got, want), f"segment_spmm {what}, {name} epilogue: the card == the plain version on the "
                                      f"CPU, bit for bit")
        check(_bits_equal(got, _flat(card())), f"segment_spmm {what}, {name} epilogue: two launches give the same bits")
        if live is not None:
            check(not got[..., ~live, :].any(), f"segment_spmm {what}, {name} epilogue: every dead row exactly 0")
        if not timed:
            continue
        ms = time_cuda(card)[0]
        b2b_ms = time_cuda(card, inner=B2B)[0]
        device_ms = _device_ms_per_call(card, "segment_spmm")
        n_bytes = bare["n_bytes"] + extra
        b_ms, b_by = bound_ms(n_bytes, 2.0 * spmm.a.col.numel() * x.shape[1] + 4.0 * x.numel())
        device = "not seen by the profiler" if device_ms is None else f"{device_ms:.4f} ms"
        say(f"segment_spmm {what}, {name} epilogue: {ms:.4f} ms, {b2b_ms:.4f} b2b ({100 * b_ms / b2b_ms:.1f} % of "
            f"the bound), device time a call {device}; bare product {bare['b2b_ms']:.4f} b2b; bound {b_ms:.4f} ms "
            f"({b_by}, {n_bytes / 1e6:.1f} MB)")
        out[name] = {"ms": ms, "b2b_ms": b2b_ms, "device_ms": device_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": float((got.cpu() - want).abs().max())}
    return out


def segment_spmm_hub(spmm, x, whole, dev):
    """Does the hub set the pace? ``segment_spmm`` on the longest row's
    edges alone, bit-equal to the plain version on the CPU, timed as the
    whole product is, beside the whole product's time, its bytes bound and
    the hub's chain floor (``segment_sum_hub``'s: its length times the
    cycles of one dependent add, by ``segment_sum``'s probe, over the top
    SM clock)."""
    from repro_torch.kernels.segment_spmm import csr_matrix, segment_spmm, segment_spmm_ref
    from repro_torch.kernels.segment_sum.ops import add_cycles

    offsets = spmm.a.offsets
    hub = int(torch.argmax(offsets[1:] - offsets[:-1]))
    b, e = (int(v) for v in offsets[hub:hub + 2])
    a = csr_matrix(torch.zeros(e - b, dtype=torch.int64, device=dev), spmm.a.col[b:e], spmm.a.scale[b:e], 1)
    got = segment_spmm(x, a)
    check(_bits_equal(got, segment_spmm_ref(x.cpu(), a.col.cpu(), a.scale.cpu(), a.ids.cpu(), 1)),
          f"segment_spmm on the hub alone ({e - b:,} edges): the card == the plain version on the CPU")
    ms = time_cuda(lambda: segment_spmm(x, a))[0]
    b2b_ms = time_cuda(lambda: segment_spmm(x, a), inner=B2B)[0]
    clock_now, clock_top = _smi_clocks()
    cycles, _ = add_cycles(dev)
    floor_ms = (e - b) * cycles / (clock_top * 1e6) * 1e3
    say(f"segment_spmm hub alone (row {hub}, {e - b:,} edges x {x.shape[1]}): {ms:.4f} ms, {b2b_ms:.4f} b2b, "
        f"against the whole product's {whole['b2b_ms']:.4f} b2b (bytes bound {whole['bound_ms']:.4f} ms); one "
        f"dependent add {cycles:.3f} cycles; SM clock {clock_now:.0f} MHz now, {clock_top:.0f} MHz top; chain floor "
        f"{floor_ms:.4f} ms")
    return {"row": hub, "edges": e - b, "ms": ms, "b2b_ms": b2b_ms, "add_cycles": cycles, "chain_floor_ms": floor_ms}


def phase1_segment_spmm(dev, graphs, records):
    """``segment_spmm`` at DiDiC's coefficient matrices at ``scale=1.0``
    (k = 4, ``x`` from seed 5), each built as ``make_spmm`` builds it (a
    ``SegmentSpmm``, its one-off build timed), held bit for bit to the plain
    version on the CPU and timed, bare and with each of DiDiC's updates as
    its epilogue; Twitter's hub also alone; k = 2 and 8 on GIS (the lane
    groups); and the capacity overlay's product on Twitter (``n_cap
    + 1`` rows of a store at the default headroom, on a copy of the graph):
    the dead rows exactly 0 though ``x`` is not, the live rows the k = 4
    product's bits, and the epilogues with the live mask. The GIS case is
    the record's timed shape."""
    from repro_torch.core.didic import SegmentSpmm, _edge_coefficients, _overlay_tables

    rng = np.random.default_rng(5)
    out = {}
    for name in ("filesystem", "gis", "twitter"):
        g = graphs[name]
        s, r, ce, degc_host = _edge_coefficients(g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spmm = SegmentSpmm(s, r, ce, g.n_nodes, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        say(f"segment_spmm {name}: the CSR matrix's one-off build (SegmentSpmm: offsets, long rows sorted, "
            f"{spmm.a.long_ids.numel():,} of them, {spmm.a.tiles.shape[0]:,} tiles of the others, at most "
            f"{spmm.a.tile_edges:,} edges a tile) {build_s:.3f} s")
        x = torch.as_tensor(rng.standard_normal((g.n_nodes, 4)).astype(np.float32), device=dev)
        out[name] = segment_spmm_case(spmm, x, f"DiDiC's {name} product")
        out[name]["build_s"] = build_s
        degc = torch.as_tensor(degc_host, device=dev)
        out[name]["epilogues"] = segment_spmm_epilogues(spmm, x, degc, f"DiDiC's {name} product", out[name])
        if name == "twitter":
            out[name]["hub"] = segment_spmm_hub(spmm, x, out[name], dev)
            bare = _bare(g)
            bare.ensure_store()
            overlay, degc_o = _overlay_tables(bare, dev)
            xo = torch.as_tensor(rng.standard_normal((overlay.a.n, 4)).astype(np.float32), device=dev)
            what = f"Twitter's capacity overlay ({overlay.a.n - g.n_nodes:,} dead rows)"
            got, _ = _spmm_check(overlay, xo, what)
            check(not got[g.n_nodes:].any(), "segment_spmm on the overlay: every dead row exactly 0")
            check(_bits_equal(got[:g.n_nodes], spmm(xo[:g.n_nodes])),
                  "segment_spmm on the overlay: the live rows equal the product without the store, bit for bit")
            live = torch.arange(overlay.a.n, device=dev) < g.n_nodes
            segment_spmm_epilogues(overlay, xo, degc_o, what, out[name], live=live, timed=False)
            del bare, overlay, xo
        if name == "gis":
            for k in (2, 8):
                xk = torch.as_tensor(rng.standard_normal((g.n_nodes, k)).astype(np.float32), device=dev)
                _spmm_check(spmm, xk, f"DiDiC's gis product, k = {k}")
        del spmm, x
    records["segment_spmm"] = {
        "name": "segment_spmm", "route": "cuda", "source": "src/repro_torch/csrc/segment_spmm.cu",
        "replaces": "none: carries bell_matmul's A_c @ W (src/repro/kernels/bsr_spmm/kernel.py:52) at the "
                    "paper's scale, where the JAX package sums ce * take(x, r) by jax.ops.segment_sum "
                    "(src/repro/core/didic.py:127)",
        **out["gis"], "filesystem": out["filesystem"], "twitter": out["twitter"],
    }


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def _exact(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("per_op_total", "per_op_global", "per_partition", "per_vertex"))


def _oracle_check(graph, ops, parts, dev, what, replicated=None) -> None:
    from repro_torch.core.traffic import OpLog, execute_ops

    sub = OpLog(ops.pattern, ops.starts[:64].copy(), ops.ends[:64].copy(), ops.t_l, ops.t_pg)
    got = execute_ops(graph, sub, parts, 4, engine="batched", device=dev, replicated=replicated)
    want = execute_ops(graph, sub, parts, 4, engine="scalar", replicated=replicated)
    check(_exact(got, want), f"{what}: batched on the card == scalar oracle, 64 ops, all four counters")


def _add_counts(main_launches, counts) -> None:
    for kname, n in counts.items():
        main_launches[kname] = main_launches.get(kname, 0) + n


def _didic_products(config, iterations: int) -> int:
    """``A_c @ X`` products of ``iterations`` DiDiC iterations from a cold
    start: ψ(ρ + 1) diffusion products an iteration (paper §4.1.3) and the
    smoothing schedule's steps, min(2^(i // smooth_double_every),
    smooth_cap) in iteration i."""
    diffusion = config.primary_steps * (config.secondary_steps + 1)
    smoothing = sum(min(1 << (i // max(config.smooth_double_every, 1)), config.smooth_cap) for i in range(iterations))
    return iterations * diffusion + smoothing


def _didic_routes(config, iterations: int) -> dict:
    """``segment_spmm``'s launches by epilogue in ``iterations`` DiDiC
    iterations from a cold start: ψ·ρ secondary and ψ primary products an
    iteration, the smoothing schedule's steps, no bare product."""
    smoothing = _didic_products(config, iterations) - iterations * config.primary_steps * (config.secondary_steps + 1)
    return {"secondary": iterations * config.primary_steps * config.secondary_steps,
            "primary": iterations * config.primary_steps, "smooth": smoothing}


def _fused_against_generic(graph, config, dev, name):
    """Two DiDiC iterations at full smoothing width (the refine's schedule)
    from one random map, through ``SegmentSpmm``'s fused calls and through
    the product wrapped in a plain callable (the eager updates around a bare
    product): w, l, parts and beta bit-equal; both timed (host clock, ending
    in a synchronize)."""
    from repro_torch.core import didic

    spmm, degc = didic.make_spmm(graph, config, dev)
    parts0 = torch.as_tensor(np.random.default_rng(11).integers(0, config.k, graph.n_nodes).astype(np.int32),
                             device=dev)
    runs, walls = [], []
    for product in (spmm, lambda v: spmm(v)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(didic._run_iterations(didic._init_state(config.k, parts0), product, degc, config, 2, seed=11,
                                          start_wide=True))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / 2 * 1e3)
    fused, generic = runs
    check(all(_bits_equal(getattr(fused, f), getattr(generic, f)) for f in ("w", "l", "parts", "beta")),
          f"{name}: 2 DiDiC iterations (smoothing {config.smooth_cap}) with the updates fused into segment_spmm == "
          f"the eager updates around it: w, l, parts and beta bit-equal ({walls[0]:.2f} against {walls[1]:.2f} "
          f"ms an iteration)")


def phase2_dataset(name, graph, dev, main_launches, held):
    """Drive the static experiment on one dataset. The launch counts of
    the DiDiC run and of each main-path replay (counts set to 0 just before
    it, read just after) are added into ``main_launches``; the checks that follow launch kernels
    too, but outside those windows. Returns the DiDiC map, its carried
    state and the 100 iterations' seconds, where phase 6 starts; keeps the
    DiDiC map's replay in ``held[name]`` for phase 12."""
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
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    svc.partition_didic(seed=0)
    torch.cuda.synchronize()
    didic_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    routes = dict(kernels.KERNELS["segment_spmm"].route_launches)
    _add_counts(main_launches, counts)
    parts["didic"] = svc.parts.copy()
    say(f"phase 2: {name} DiDiC {DIDIC_ITERATIONS} iterations (segment_spmm): {didic_s:.2f} s, "
        f"{didic_s / DIDIC_ITERATIONS * 1e3:.2f} ms/iteration")
    products = _didic_products(config, DIDIC_ITERATIONS)
    check(counts["segment_spmm"] == products,
          f"{name}: each of DiDiC's {products:,} products one segment_spmm launch ({counts['segment_spmm']:,})")
    check(routes == _didic_routes(config, DIDIC_ITERATIONS),
          f"{name}: each product's update in its launch's epilogue ({json.dumps(routes, sort_keys=True)})")
    check(counts["bell_matmul"] == 0, f"{name}: DiDiC's segment route launched no bell_matmul")
    _fused_against_generic(graph, config, dev, name)

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
        if pname == "didic":
            held[name] = {"parts": p.copy(), "result": res}
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
          f"{name}: DiDiC through segment_spmm, 5 iterations twice: bit-equal parts and w")
    return parts["didic"], svc.runtime.state, didic_s


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
def phase3(dev, main_launches):
    """DiDiC's kernel route (``bell_matmul``) against its segment route
    (``segment_spmm``). Both runs are main-path runs: their launch counts
    (set to 0 just before each, read just after) are added into
    ``main_launches``. Returns the graph and the kernel route's map, where
    phase 6's kernel-route Stress starts."""
    from repro_torch import kernels
    from repro_torch.core import metrics
    from repro_torch.core.didic import DidicConfig, didic_partition
    from repro_torch.graphs import datasets

    gis = datasets.load("gis", scale=0.01)
    cuts = {}
    for use_kernel in (False, True):
        config = DidicConfig(k=4, iterations=20, use_kernel=use_kernel, block_size=128)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        p, _ = didic_partition(gis, config, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        _add_counts(main_launches, counts)
        route = "kernel" if use_kernel else "segment"
        cuts[route] = metrics.edge_cut_fraction(gis, p)
        bell, spmm = counts["bell_matmul"], counts["segment_spmm"]
        say(f"phase 3: GIS 0.01 DiDiC {route} route, 20 iterations: edge cut {cuts[route]:.4f}, "
            f"{wall / 20 * 1e3:.2f} ms/iteration, bell_matmul launches {bell}, segment_spmm launches {spmm}")
        if use_kernel:
            check(bell > 0 and spmm == 0, "DiDiC's kernel route went through bell_matmul and launched no segment_spmm")
        else:
            check(spmm == _didic_products(config, 20) and bell == 0,
                  f"DiDiC's segment route: every product one segment_spmm launch ({spmm}), no bell_matmul")
    ratio = max(cuts.values()) / max(min(cuts.values()), 1e-12)
    check(ratio <= 1.5, f"kernel-route edge cut within 1.5x of the segment route's ({ratio:.3f}x)")
    return gis, p


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------
N_OPS_GIS_DYNAMIC = 500         # phase 6's GIS log (the GIS replay is host-paced; cut from 2,000 for time)
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


@contextlib.contextmanager
def _growth_timers():
    """Time, the card synchronised on both sides, each adoption of a grown
    graph by a store's engine (``adopt_s``; calls that find the engine
    already on the graph are not counted) and each build of the overlay
    DiDiC tables (``repad_s``), while the block runs."""
    from repro_torch.core import didic
    from repro_torch.core.traffic_batched import BatchedTrafficEngine

    timers = {"adopt_s": [], "repad_s": []}
    adopt, tables = BatchedTrafficEngine.adopt, didic._overlay_tables

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            before = args[0]._struct_version if key == "adopt_s" else None
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if key != "adopt_s" or args[0]._struct_version != before:
                timers[key].append(time.perf_counter() - t0)
            return out
        return run

    BatchedTrafficEngine.adopt = timed(adopt, "adopt_s")
    didic._overlay_tables = timed(tables, "repad_s")
    try:
        yield timers
    finally:
        BatchedTrafficEngine.adopt, didic._overlay_tables = adopt, tables


def _pg(res) -> float:
    return 100.0 * res.percent_global


def phase6_dataset(name, graph, start, dev, main_launches, held):
    """The paper's dynamic experiments (Chapter 7) on one dataset at the
    paper's scale, from phase 2's DiDiC map and carried state, with the
    parameters of the JAX package's ``benchmarks/paper_tables.py``: Insert
    (§7.4), Stress (§7.5), Dynamic (§7.6) with its unmaintained comparator,
    Insert with vertex growth, and the maintenance cost. Every replay and
    maintenance run here is a main-path run (its launches counted). The
    DiDiC map's replay of this phase's log is kept in ``held[name]`` for
    phase 12."""
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
    held[name]["phase6_result"] = base
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run, counts = _counted(lambda: DynamicExperimentRuntime(svc, "random", seed=0).run(
            ops, n_slices=5, amount=0.05, maintain_every=1), main_launches)
        run_s = time.perf_counter() - t0
        collect(svc)
        return run, counts["frontier_gather"], run_s

    run, n, dynamic_s = dynamic()
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
    # What phase 18 holds its mesh tables to.
    held[name]["phase6"] = {"ops": ops, "parts": parts0, "config": config, "stress": out["stress"],
                            "dynamic": [r["T_G_percent"] for r in out["dynamic"]],
                            "unmaintained": out["dynamic_unmaintained_T_G_percent"],
                            "dynamic_s": dynamic_s}
    if name == "twitter":
        again, n, _ = dynamic()
        fg += n
        check([vars(r) for r in again.records] == [vars(r) for r in run.records]
              and np.array_equal(again.parts, run.parts),
              f"{name} dynamic run twice: identical records and final map")

    # Insert with vertex growth: least_traffic, 30 % of the units allocate a
    # vertex, 4 slices of 5 %, maintenance every second slice. The first
    # growth slice attaches a store to the dataset's graph; every grown
    # graph is adopted by its engine and DiDiC tables.
    grown = []
    svc = _service(graph, config, dev, parts0, state0)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _growth_timers() as timers:
        growth, counts = _counted(lambda: DynamicExperimentRuntime(svc, "least_traffic", seed=0).run(
            ops, n_slices=4, amount=0.05, maintain_every=2, insert_rate=0.3,
            on_slice=lambda i, r: grown.append(_bare(svc.graph))), main_launches)
    fg += counts["frontier_gather"]
    growth_peak = torch.cuda.max_memory_allocated()
    n_grown = svc.graph.n_nodes - graph.n_nodes
    store = svc.graph.store
    check(n_grown == sum(r.inserted for r in growth.records) > 0,
          f"{name} growth: {n_grown} vertices grown over 4 slices, one per insert unit")
    check(store is not None and graph.store is store and store.compactions == 0
          and len(timers["adopt_s"]) == 4,
          f"{name} growth: one store (n_cap {store.n_cap}, e_cap {store.e_cap}) carried over the "
          f"4 slices, the engine adopting each grown graph ({len(timers['adopt_s'])} adoptions)")
    _oracle_check(svc.graph, ops, svc.parts, dev, f"{name} growth, last grown graph ({svc.graph.n_nodes} vertices)")
    growth_replay_s = list(svc.run_ops.seconds)
    growth_refine_s = list(svc.runtime.maintain.seconds)
    collect(svc)
    geometry = {"n_cap": store.n_cap, "e_cap": store.e_cap, "base_nodes": store.base_nodes,
                "base_edges": store.base_edges, "compactions": store.compactions,
                "headroom": store.headroom}
    del svc, store
    # The later phases start from the storeless graph, as before.
    graph.store = None
    builds = [_engine_build_seconds(g, ops.pattern, dev) for g in grown]
    del grown
    out["growth"] = {
        "records": [{"T_G_percent": 100 * r.percent_global, "inserted": r.inserted,
                     "migrated": r.migrated, "maintained": r.maintained} for r in growth.records],
        "grown_vertices": n_grown, "replay_s": growth_replay_s, "refine_s": growth_refine_s,
        "engine_build_s": builds, "adopt_s": timers["adopt_s"],
        "table_repad_s": timers["repad_s"], "store": geometry,
        "peak_device_bytes": growth_peak,
    }
    say(f"phase 6: {name} growth: +{n_grown} vertices, T_G % per slice "
        + ", ".join(f"{r['T_G_percent']:.4f}" for r in out["growth"]["records"])
        + "; engine adoption a growth slice " + ", ".join(f"{t:.3f}" for t in timers["adopt_s"])
        + " s against a fresh build " + ", ".join(f"{b:.2f}" for b in builds)
        + " s; DiDiC table re-pads " + ", ".join(f"{t:.3f}" for t in timers["repad_s"])
        + " s; maintenance on the grown graphs "
        + ", ".join(f"{t:.2f}" for t in growth_refine_s) + f" s; store {json.dumps(geometry)}; "
        f"peak {growth_peak} B")

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


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------
PLACEMENT_CAPACITY = 128        # the JAX package's largest skew-sweep table
TABLES_SCALE = 0.01             # the paper tables inside this script (full scale: own calls)
TABLES_DIDIC_ITERATIONS = 20


def phase7_placement(name, graph, start, dev, main_launches):
    """The hot-vertex placement on one dataset at the paper's scale, from
    phase 2's DiDiC map: a service with an exception table of 128 replays
    the log, re-selects the table from its per-vertex traffic and replays
    again; capacities 8 and 32 replay with the same traffic's top
    vertices. Every replay is a main-path run."""
    from repro_torch.core import metrics
    from repro_torch.core.didic import DidicConfig
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.partitioners import select_hot_vertices
    from repro_torch.core.traffic import execute_ops, generate_ops
    from repro_torch.skew_smoke import hot_mask

    parts0 = start[0]
    n_ops = N_OPS_GIS_DYNAMIC if name == "gis" else N_OPS
    ops = generate_ops(graph, n_ops=n_ops, seed=0)
    svc = PartitionedGraphService(graph, 4, DidicConfig(k=4), device=dev,
                                  exception_capacity=PLACEMENT_CAPACITY)
    svc.partition_with(parts0.copy())
    fg = 0
    (base, base_s), counts = _counted(lambda: once(lambda: svc.run_ops(ops)), main_launches)
    fg += counts["frontier_gather"]
    sweep = {0: base}
    seconds = {0: base_s}
    for cap in (8, 32):
        mask = hot_mask(base.per_vertex, cap)
        (sweep[cap], seconds[cap]), counts = _counted(lambda: once(lambda: execute_ops(
            graph, ops, parts0, 4, device=dev, replicated=mask)), main_launches)
        fg += counts["frontier_gather"]
    hot = svc.refresh_placement()
    check(np.array_equal(hot, select_hot_vertices(base.per_vertex, PLACEMENT_CAPACITY))
          and svc.placement.replica_epoch == 1,
          f"{name}: refresh_placement picked the top {hot.size} vertices of the replay's traffic")
    (sweep[128], seconds[128]), counts = _counted(lambda: once(lambda: svc.run_ops(ops)),
                                                  main_launches)
    fg += counts["frontier_gather"]
    out = {"phase": 7, "dataset": name, "n_ops": n_ops, "sweep": {}}
    for cap, res in sweep.items():
        out["sweep"][str(cap)] = {
            "T_G_percent": _pg(res), "global": int(res.per_op_global.sum()),
            "load_cv": metrics.coefficient_of_variation(res.per_partition),
            "replay_s": seconds[cap],
        }
        check(res.per_op_total.sum() == base.per_op_total.sum()
              and res.per_partition.sum() == base.per_partition.sum()
              and np.array_equal(res.per_vertex, base.per_vertex)
              and _pg(res) <= _pg(base),
              f"{name} capacity {cap}: totals conserved, T_G % {_pg(res):.4f} <= {_pg(base):.4f}")
    out["frontier_gather_launches"] = fg
    say(json.dumps(out))
    say(f"phase 7: {name} T_G % / load CV at capacities 0, 8, 32, 128: " + "; ".join(
        f"{v['T_G_percent']:.4f} / {v['load_cv']:.4f}" for v in out["sweep"].values()))
    if name == "gis":
        check(fg > 0, f"gis phase 7: the masked replays went through frontier_gather ({fg} launches)")
        _oracle_check(graph, ops, parts0, dev, f"{name} capacity {PLACEMENT_CAPACITY}",
                      replicated=svc.placement.replicated_mask())


def phase7_skew(dev):
    """``skew_smoke`` at the JAX package's own parameters, its gates fatal."""
    from repro_torch import skew_smoke

    rows, update = skew_smoke.skew_smoke(device=dev)
    for row in rows:
        say(f"phase 7: {row}")
    say(json.dumps({"phase": 7, "skew": update}, sort_keys=True))
    # The JAX package's figures from its own CPU run (benchmarks/BENCH_traffic.json, "skew").
    reference = {"twitter": "441 -> 136 (0.6916)", "filesystem": "10709 -> 10572 (0.0128)"}
    for name, ref in reference.items():
        sw = update[name]["sweep"]
        say(f"phase 7: skew {name} global traffic at capacity 0 -> 128 on the card: "
            f"{sw['0']['global_traffic']:.0f} -> {sw['128']['global_traffic']:.0f} "
            f"({update[name]['reduction_at_128']}); the JAX package's CPU run: {ref}")
    check(update["twitter"]["reduction_at_128"] >= 0.20,
          "skew_smoke: Twitter's global traffic falls >= 20 % at 128 replicas, filesystem "
          "never rises > 1 %, scalar == batched at every capacity")


def phase7_tables(dev, main_launches):
    """The paper's nine tables at ``scale=0.01`` through the port's entry
    point: every row name as the CPU parity test pins it, finite values,
    DiDiC below random on every dataset and k."""
    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.paper_tables import TABLES, PaperBench, row_names

    cfg = PaperExperimentConfig(scale=TABLES_SCALE, didic_iterations=TABLES_DIDIC_ITERATIONS)
    bench = PaperBench(cfg, device=dev)
    (rows, tables_s), counts = _counted(lambda: once(bench.all_tables), main_launches)
    for r in rows:
        say(f"phase 7 table: {r.csv()}")
    want = []
    for key, fn in TABLES.items():
        want += row_names(cfg, key) + [f"_timing/{fn}_s"]
    check([r.name for r in rows] == want, f"paper tables: {len(rows)} rows, names as pinned")
    check(all(np.isfinite(r.value) for r in rows), "paper tables: every value finite")
    reductions = {r.name: r.value for r in rows
                  if r.name.endswith("/didic/traffic_reduction_pct")}
    check(len(reductions) == 6 and min(reductions.values()) > 0,
          "paper tables: DiDiC below random on every dataset and k: "
          + ", ".join(f"{n.split('/')[1]} k{n.split('/')[2][1:]} {v}" for n, v in reductions.items()))
    check(counts["frontier_gather"] > 0,
          f"paper tables: the GIS replays went through frontier_gather ({counts['frontier_gather']})")
    say(json.dumps({"phase": 7, "tables_s": tables_s, "rows": len(rows),
                    "frontier_gather_launches": counts["frontier_gather"]}))


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------
# Cut for the script's time (PERF.md §4): 4 slices, not 6 (the fewest the
# fault plan needs: its post-commit crash at slice 3, snapshots every 3rd
# slice, so both recoveries, the journal's rollback and replay and the two
# maintenance retries all occur), and 40 online requests, not 256 (10 ticks
# of uniform arrivals: enough for a background DiDiC round, every 8 ticks, to
# commit, so the legs serve more than one epoch).
RECOVERY_RUN = dict(n_slices=4, amount=0.05, maintain_every=3, insert_rate=0.2)
RECOVERY_SNAPSHOT_EVERY = 3
ONLINE_REQUESTS = 40
GIS_CLASSES = ("gis_short", "gis_long")
SLO = {"gis_short": 8, "gis_long": 16}


def _recovery_plan():
    from repro_torch.core.fault import FaultPlan

    return (FaultPlan().crash(1, site="apply:pre_commit").timeout_maintenance(2, times=2)
            .crash(3, site="apply:post_commit"))


def _online_plan():
    from repro_torch.core.fault import FaultPlan

    return FaultPlan().crash(3, site="serve:admit").crash(5, site="serve:commit")


def _served(res):
    """An online result's counters in ``offline_replay``'s shape."""
    return res.per_op, res.per_partition, res.per_vertex


def _served_equal(a, b) -> bool:
    """Equal per-op, per-partition and per-vertex counters of two
    ``(per_op, per_partition, per_vertex)`` triples."""
    return (a[0].keys() == b[0].keys() and all(np.array_equal(a[0][c], b[0][c]) for c in a[0])
            and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]))


def phase8_recovery(name, graph, start, dev, main_launches):
    """Crash recovery on one dataset at the paper's scale, from phase 2's
    DiDiC map and state: ``run_with_recovery`` (snapshots every 3 slices,
    each round-tripped through its bytes) under a pre-commit crash, two
    maintenance timeouts and a post-commit crash, against an uninterrupted
    run of the same slices. Both runs are main-path runs."""
    import gc

    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
    from repro_torch.core.fault import RetryPolicy
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.recovery import run_with_recovery
    from repro_torch.core.traffic import generate_ops

    parts0, state0, _ = start
    cfg = PaperExperimentConfig(didic_iterations=DIDIC_ITERATIONS)
    config = cfg.didic(name, 4)
    ops = generate_ops(graph, n_ops=cfg.n_ops_gis if name == "gis" else cfg.n_ops, seed=0)
    loggers = []  # host-only, so a dead runtime's device memory is not held

    def make():
        svc = PartitionedGraphService(graph, 4, config, device=dev)
        svc.runtime.state = state0
        svc.partition_with(parts0.copy())
        loggers.append(svc.logger)
        return DynamicExperimentRuntime(svc, "least_traffic", seed=0)

    base, got = {}, {}
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    (ref, ref_s), counts = _counted(lambda: once(lambda: make().run(
        ops, on_slice=lambda i, r: base.__setitem__(i, r), **RECOVERY_RUN)), main_launches)
    ref_peak = torch.cuda.max_memory_allocated()
    fg = counts["frontier_gather"]
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    ((out, stats), rec_s), counts = _counted(lambda: once(lambda: run_with_recovery(
        make, graph, ops, fault_plan=_recovery_plan(), retry_policy=RetryPolicy(),
        snapshot_every=RECOVERY_SNAPSHOT_EVERY, on_slice=lambda i, r: got.__setitem__(i, r), **RECOVERY_RUN)),
        main_launches)
    rec_peak = torch.cuda.max_memory_allocated()
    fg += counts["frontier_gather"]
    # Both legs grew through the store the first attached to the dataset's
    # graph; the later phases start from the storeless graph, as before.
    geometry = (graph.store.n_cap, graph.store.e_cap) if graph.store is not None else None
    graph.store = None
    health = loggers[-1].health_report()
    n = RECOVERY_RUN["n_slices"]
    say(json.dumps({
        "phase": 8, "dataset": name, "recovery": {
            "n_ops": ops.n_ops, "uninterrupted_s": ref_s, "recovered_s": rec_s,
            "recoveries": stats.recoveries, "resumed_from": stats.resumed_from,
            "recovery_time_s": stats.recovery_time_s, "restore_s": stats.restore_s,
            "snapshot_bytes": stats.snapshot_bytes, "capture_s": stats.capture_s,
            "journal_rolled_back": stats.journal_rolled_back,
            "journal_replayed": stats.journal_replayed,
            "maintenance_retries": health["maintenance_retries"],
            "peak_device_bytes": [ref_peak, rec_peak],
            "T_G_percent": [_pg(base[i]) for i in range(n)],
            "grown_vertices": int(sum(r.inserted for r in out.records)),
            "store_capacity": geometry,
            "frontier_gather_launches": fg,
        }}))
    check(stats.recoveries == health["recoveries"] == 2 and stats.journal_rolled_back >= 1
          and stats.journal_replayed >= 1 and health["maintenance_retries"] == 2,
          f"{name} recovery: 2 recoveries (resumed at {stats.resumed_from}), "
          f"{stats.journal_rolled_back} journal entries rolled back, {stats.journal_replayed} "
          f"replayed, 2 maintenance retries")
    check(all(_exact(base[i], got[i]) for i in range(n))
          and [vars(r) for r in out.records] == [vars(r) for r in ref.records]
          and np.array_equal(out.parts, ref.parts),
          f"{name} recovery: all four counters equal the uninterrupted run's on each of {n} "
          f"slices, with equal records and final map")
    check(rec_peak <= 1.1 * ref_peak,
          f"{name} recovery: peak device memory {rec_peak} B within 10 % of the "
          f"uninterrupted run's {ref_peak} B")
    if name == "gis":
        check(fg > 0, f"gis phase 8 recovery: the replays went through frontier_gather ({fg} launches)")


def _online_leg(svc, graph, classes, process, plan, dev, main_launches, maintenance=True):
    """Serve ``ONLINE_REQUESTS`` arrivals of ``classes`` on ``svc`` under
    ``plan``, then replay its epochs offline. Serving is the main-path run;
    the offline replay is the reference it is checked against, so its
    launches are read apart and not counted as main path. Returns the
    result, the serving seconds, the offline counters and the serving's and
    the offline replay's ``frontier_gather`` launches."""
    from repro_torch.core.online import (BackgroundMaintenance, OnlineServer, make_arrival_stream,
                                         offline_replay)

    arrivals, t_counts = make_arrival_stream(graph, classes, ONLINE_REQUESTS, seed=0, process=process)
    svc.fault_plan = plan
    server = OnlineServer(svc, batch_slots=8, queue_limit=64,
                          maintenance=BackgroundMaintenance(svc, every=8) if maintenance else None,
                          slo=SLO if classes == GIS_CLASSES else None)
    server.submit_stream(arrivals, t_counts)
    (res, seconds), counts = _counted(lambda: once(server.run), main_launches)
    off, offline_counts = _counted(
        lambda: offline_replay(graph, res.epochs, 4, t_counts, device=dev), {})
    return res, seconds, off, counts["frontier_gather"], offline_counts["frontier_gather"]


def phase8_online(graph, start, dev, main_launches):
    """The online server on GIS at the paper's scale, from phase 2's DiDiC
    map and state: ``gis_short``/``gis_long`` clients under each arrival
    process, 8-slot batches, a 64-op queue, background DiDiC rounds every 8
    ticks and SLOs of 8 and 16 ticks; a clean leg and a leg with an admit
    and a commit crash, each equal to the offline replay of its epochs."""
    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.core.framework import PartitionedGraphService

    parts0, state0, _ = start
    config = PaperExperimentConfig(didic_iterations=DIDIC_ITERATIONS).didic("gis", 4)
    fg = 0
    for process in ("uniform", "bursty", "skewed_hot"):
        legs = {}
        for leg, plan in (("clean", None), ("crash", _online_plan())):
            svc = PartitionedGraphService(graph, 4, config, device=dev)
            svc.runtime.state = state0
            svc.partition_with(parts0.copy())
            res, seconds, off, n, n_off = _online_leg(svc, graph, GIS_CLASSES, process, plan,
                                                      dev, main_launches)
            fg += n
            legs[leg] = res
            say(json.dumps({"phase": 8, "dataset": "gis", "online": process, "leg": leg,
                            "ops": res.ops_served, "seconds": seconds,
                            "ops_per_s": res.ops_served / seconds, "ticks": res.ticks,
                            "batches": res.batches_served, "epochs": len(res.epochs),
                            "latency": res.latency, "health": res.health,
                            "frontier_gather_launches": n,
                            "offline_frontier_gather_launches": n_off}))
            check(res.ops_served == ONLINE_REQUESTS and len(res.epochs) >= 2
                  and _served_equal(_served(res), off),
                  f"gis online {process} {leg}: {res.ops_served} ops served over {res.ticks} ticks "
                  f"and {len(res.epochs)} epochs (a DiDiC round migrated), equal to the offline "
                  f"replay of its epochs")
        clean, crash = legs["clean"], legs["crash"]
        check(crash.health["recoveries"] == 2 and _served_equal(_served(crash), _served(clean))
              and crash.latency == clean.latency and crash.ticks == clean.ticks,
              f"gis online {process}: the crash leg (2 recoveries) equals the clean leg on every "
              f"counter and the latency report")
        say(f"phase 8: gis online {process}: "
            + ", ".join(f"{c} wait p50/p99 {r['queue_wait_p50']}/{r['queue_wait_p99']} ticks"
                        for c, r in clean.latency.items()))
    check(fg > 0, f"gis phase 8 online: the replays went through frontier_gather ({fg} launches)")


def phase8_replicas(graph, start, dev, main_launches):
    """Online serving with replicas: the filesystem graph plus one parking
    vertex (the Twitter class's inert pad), phase 2's map extended by it,
    an exception table of 128 promoted by ``refresh_placement`` after a
    priming replay; ``filesystem``/``twitter`` clients with ``skewed_hot``
    arrivals, a clean and a crash leg, each equal to its offline replay."""
    from repro_torch.core.didic import DidicConfig
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.traffic import generate_ops

    parked = graph.with_vertices(1)
    parts = np.concatenate([start[0], np.zeros(1, np.int32)])
    prime = generate_ops(parked, n_ops=N_OPS, seed=5)
    legs = {}
    for leg, plan in (("clean", None), ("crash", _online_plan())):
        svc = PartitionedGraphService(parked, 4, DidicConfig(k=4), device=dev,
                                      exception_capacity=PLACEMENT_CAPACITY)
        svc.partition_with(parts)
        _counted(lambda: svc.run_ops(prime), main_launches)
        hot = svc.refresh_placement()
        res, seconds, off, _, _ = _online_leg(svc, parked, ("filesystem", "twitter"), "skewed_hot", plan,
                                           dev, main_launches, maintenance=False)
        legs[leg] = res
        say(json.dumps({"phase": 8, "dataset": "filesystem+1", "online": "skewed_hot", "leg": leg,
                        "hot": int(hot.size), "ops": res.ops_served, "seconds": seconds,
                        "ops_per_s": res.ops_served / seconds, "ticks": res.ticks,
                        "latency": res.latency}))
        check(hot.size > 0 and res.ops_served == ONLINE_REQUESTS
              and _served_equal(_served(res), off),
              f"filesystem+1 online with {hot.size} replicas, {leg}: equal to the offline replay "
              f"of its epochs")
    check(legs["crash"].health["recoveries"] == 2
          and _served_equal(_served(legs["crash"]), _served(legs["clean"])),
          "filesystem+1 online with replicas: the crash leg equals the clean leg")


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


#: (Hq, Hkv) of the LM configs' prefill beyond granite's (32, 8): yi-34b and
#: deepseek-coder-33b (group 7), qwen3-moe-30b-a3b (group 8, d_head 128 at
#: d_model 2048), deepseek-moe-16b (group 1).
FLASH_GROUPS = ((56, 8), (32, 4), (16, 16))


def phase1_flash_groups(dev):
    """``flash_attention`` at the other LM configs' prefill shapes (B=1,
    T=4,096, Dh=128, bf16, causal) against its plain version, with the bar of
    granite's shape (``bf16_gaps``), and its time beside SDPA's on the same
    call."""
    from repro_torch.kernels.flash_attention import KERNEL, attention_ref, flash_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    t, dh = 4096, 128
    out = {}
    for hq, hkv in FLASH_GROUPS:
        gen = torch.Generator(device=dev).manual_seed(3)
        q, k, v = (torch.randn((h, t, dh), generator=gen, device=dev).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        wgmma = KERNEL.route_launches.get("wgmma", 0)
        got = flash_attention(q, k, v)
        check(KERNEL.route_launches.get("wgmma", 0) == wgmma + 1,
              f"flash_attention [{hq}x{t}x{dh}], kv {hkv} (group {hq // hkv}) took the tensor-core route")
        want = attention_ref(q, k, v)
        close, err, tile_gap = bf16_gaps(got, want)
        check(close and tile_gap <= 2.0 ** -7,
              f"flash_attention bf16 [{hq}x{t}x{dh}], kv {hkv}: within two bf16 steps (max abs {err:.3g}) and "
              f"every (head, 64-query tile) within 2^-7 relative L2 (largest {tile_gap:.3g})")
        del got, want
        q4, k4, v4 = q[None], k[None], v[None]
        ms = time_cuda(lambda: flash_attention(q, k, v))[0]
        b2b_ms = time_cuda(lambda: flash_attention(q, k, v), inner=B2B)[0]
        plain_ms = time_cuda(lambda: attention_ref(q, k, v), reps=5)[0]
        library_ms = time_cuda(lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True))[0]
        library_b2b_ms = time_cuda(lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True), inner=B2B)[0]
        n_flops = 4.0 * hq * (t * (t + 1) // 2) * dh
        n_bytes = (2 * hq + 2 * hkv) * t * dh * 2
        b_ms, b_by = bound_ms(n_bytes, n_flops, PEAK_BF16_FLOPS)
        say(f"phase 1: flash_attention bf16 causal [{hq}x{t}x{dh}], kv {hkv}: kernel (wgmma) {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {n_flops / 1e9:.1f} GFLOP at 989 TFLOP/s), {100 * b_ms / ms:.1f} % of the bound; "
            f"{B2B} calls back to back: kernel {b2b_ms:.4f} ms, scaled_dot_product_attention "
            f"{library_b2b_ms:.4f} ms")
        out[f"{hq}/{hkv}"] = {"max_abs_err": err, "ms": ms, "b2b_ms": b2b_ms, "plain_ms": plain_ms,
                              "library_ms": library_ms, "library_b2b_ms": library_b2b_ms,
                              "bound_ms": b_ms, "bound_by": b_by}
    say(json.dumps({"phase": 1, "flash_attention_groups": out}))


def _bwd_inputs(dev, gen, dtype, b, hq, hkv, tq, tk, dh):
    """q, k, v and dout for a backward check, drawn on the card."""
    return [torch.randn((b * h, t, dh), generator=gen, device=dev).to(dtype)
            for h, t in ((hq, tq), (hkv, tk), (hkv, tk), (hq, tq))]


def _bwd_against_plain(q, k, v, dout, causal, q_offset, tol, what):
    """``flash_attention_bwd`` (one counted launch on its route) against the
    plain o/lse backward on the same inputs (the kernel forward's output and
    log-sum-exp), dq, dk and dv within ``tol``; a second call gives the same
    bits. Returns the largest gap."""
    from repro_torch.kernels.flash_attention import BWD_KERNEL
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_lse_ref

    route, _ = flash_ops.plan_bwd(q.dtype, q.shape[-1])
    out, lse = flash_ops._kernel_call(q, k, v, causal=causal, q_offset=q_offset, with_lse=True)
    n = BWD_KERNEL.route_launches.get(route, 0)
    got = flash_ops._bwd_kernel_call(q, k, v, out, lse, dout, causal=causal, q_offset=q_offset)
    check(BWD_KERNEL.route_launches.get(route, 0) == n + 1, f"{what}: one flash_attention_bwd launch on {route}")
    want = attention_bwd_lse_ref(q, k, v, out, lse, dout, causal=causal, q_offset=q_offset)
    errs = []
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        err = float((g.float() - w.float()).abs().max())
        check(g.dtype == x.dtype and g.shape == x.shape and bool(torch.isfinite(g).all())
              and torch.allclose(g.float(), w.float(), rtol=tol, atol=tol),
              f"{what}: {name} within {tol:g} of the plain o/lse backward (max abs {err:.3g})")
        errs.append(err)
    again = flash_ops._bwd_kernel_call(q, k, v, out, lse, dout, causal=causal, q_offset=q_offset)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two backward calls give the same bits")
    return max(errs)


def phase1_flash_backward(dev, records):
    """``flash_attention``'s backward, the hand-written ``flash_attention_bwd``:
    against the plain o/lse backward at the JAX tests' shapes in float32
    (within 1e-5, the ``ffma`` route) and bfloat16 (3e-2, ``wgmma``), at the
    other LM configs' prefill groups and at granite-3-8b's prefill shape (B
    1, T 4,096, Hq 32, Hkv 8, Dh 128, causal, bf16; 3e-2), two calls bit-equal
    each time; at granite's shape also the ``autograd.Function`` against
    autograd through the plain version, and the times: forward plus backward
    (single and back to back), the backward alone, the plain backward and
    SDPA's backward alone (``autograd.grad`` on a retained graph, its library
    time), beside the bound, and the device time of each of the backward's
    three CUDA kernels in one call (``torch.profiler``)."""
    from repro_torch.kernels.flash_attention import BWD_KERNEL, KERNEL, attention_ref, flash_attention
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import TEST_SHAPES, attention_bwd_lse_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        for b, hq, hkv, tq, tk, dh, causal, qoff in TEST_SHAPES:
            _bwd_against_plain(*_bwd_inputs(dev, gen, dtype, b, hq, hkv, tq, tk, dh), causal, qoff, tol,
                               f"flash_attention_bwd {str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} Tq={tq} Tk={tk} "
                               f"Dh={dh} causal={causal} q_offset={qoff}")
    for hq, hkv in FLASH_GROUPS:
        _bwd_against_plain(*_bwd_inputs(dev, gen, torch.bfloat16, 1, hq, hkv, 4096, 4096, 128), True, 0, 3e-2,
                           f"flash_attention_bwd bf16 [{hq}x4096x128], kv {hkv}")

    hq, hkv, t, dh = 32, 8, 4096, 128
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v, dout = _bwd_inputs(dev, gen, torch.bfloat16, 1, hq, hkv, t, t, dh)
    err = _bwd_against_plain(q, k, v, dout, True, 0, 3e-2,
                             f"flash_attention_bwd bf16 at granite's prefill shape [{hq}x{t}x{dh}], kv {hkv}")
    for x in (q, k, v):
        x.requires_grad_(True)
    launches, bwd_launches = KERNEL.launches, BWD_KERNEL.launches
    out = flash_attention(q, k, v)
    check(KERNEL.launches == launches + 1, "flash_attention under autograd: one forward launch")
    got = torch.autograd.grad(out, (q, k, v), dout)
    check(KERNEL.launches == launches + 1 and BWD_KERNEL.launches == bwd_launches + 1
          and BWD_KERNEL.route_launches.get("wgmma", 0) > 0,
          "flash_attention's backward: one flash_attention_bwd launch on wgmma, no forward launch")
    want = torch.autograd.grad(attention_ref(q, k, v), (q, k, v), dout)
    errs = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        e = float((g.float() - w.float()).abs().max())
        check(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
              and torch.allclose(g.float(), w.float(), rtol=3e-2, atol=3e-2),
              f"flash_attention forward + backward at granite's prefill shape: {name} within 3e-2 of the plain "
              f"version's autograd (max abs {e:.3g})")
        errs.append(e)
    del out, got, want
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, d4 = q[None], k[None], v[None], dout[None]

    def port():
        return torch.autograd.grad(flash_attention(q, k, v), (q, k, v), dout)

    def plain():
        return torch.autograd.grad(attention_ref(q, k, v), (q, k, v), dout)

    def library():
        return torch.autograd.grad(sdpa(q4, k4, v4, is_causal=True, enable_gqa=True), (q, k, v), d4)

    ms = time_cuda(port, reps=5)[0]
    b2b_ms = time_cuda(port, reps=3, inner=B2B)[0]
    plain_ms = time_cuda(plain, reps=3)[0]
    library_ms = time_cuda(library)[0]
    library_b2b_ms = time_cuda(library, inner=B2B)[0]

    # The backward alone: the kernel's wrapper on the saved output and
    # log-sum-exp; autograd's backward on a retained graph, the port's and SDPA's.
    qd, kd, vd = (x.detach() for x in (q, k, v))
    o, lse = flash_ops._kernel_call(qd, kd, vd, causal=True, q_offset=0, with_lse=True)
    bwd_ms = time_cuda(lambda: flash_ops._bwd_kernel_call(qd, kd, vd, o, lse, dout, causal=True, q_offset=0))[0]
    bwd_b2b_ms = time_cuda(lambda: flash_ops._bwd_kernel_call(qd, kd, vd, o, lse, dout, causal=True, q_offset=0),
                           inner=B2B)[0]
    bwd_plain_ms = time_cuda(lambda: attention_bwd_lse_ref(qd, kd, vd, o, lse, dout), reps=3)[0]
    bwd_split = _bwd_kernel_split(lambda: flash_ops._bwd_kernel_call(qd, kd, vd, o, lse, dout, causal=True,
                                                                      q_offset=0))
    out = flash_attention(q, k, v)
    port_bwd_ms = time_cuda(lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True))[0]
    lib_out = sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)
    library_bwd_ms = time_cuda(lambda: torch.autograd.grad(lib_out, (q, k, v), d4, retain_graph=True))[0]
    library_bwd_b2b_ms = time_cuda(lambda: torch.autograd.grad(lib_out, (q, k, v), d4, retain_graph=True),
                                   inner=B2B)[0]
    del out, lib_out, o, lse
    pairs = t * (t + 1) // 2
    n_flops = 12.0 * hq * pairs * dh              # q.k and p.v forward; dv, dp, dq, dk backward
    n_bytes = (2 * hq + 2 * hkv) * t * dh * 2 * 2  # q, k, v, dO read; dq, dk, dv, o written, bf16
    b_ms, b_by = bound_ms(n_bytes, n_flops, PEAK_BF16_FLOPS)
    bwd_flops = 8.0 * hq * pairs * dh             # the four products of the gradient
    bwd_done = 10.0 * hq * pairs * dh             # what the one sweep computes (S and dP once)
    # q, o, dO, k, v and lse read once; dq, dk, dv written once
    bwd_bytes = (3 * hq + 2 * hkv) * t * dh * 2 + hq * t * 4 + (hq + 2 * hkv) * t * dh * 2
    bb_ms, bb_by = bound_ms(bwd_bytes, bwd_flops, PEAK_BF16_FLOPS)
    say(f"phase 1: flash_attention forward + backward, bf16 causal [{hq}x{t}x{dh}], kv {hkv}: kernels {ms:.4f} ms "
        f"({b2b_ms:.4f} ms a call over {B2B} back to back), plain forward and backward {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention forward and backward {library_ms:.4f} ms ({library_b2b_ms:.4f} b2b), "
        f"bound {b_ms:.4f} ms ({b_by}: {n_flops / 1e9:.1f} GFLOP at 989 TFLOP/s); {b2b_ms / library_b2b_ms:.2f}x "
        f"SDPA b2b")
    split = ", ".join(f"{name} {ms_:.4f} ms" for name, ms_ in bwd_split.items()) or "not measured"
    say(f"phase 1: flash_attention_bwd (wgmma) alone at granite's shape: kernel {bwd_ms:.4f} ms ({bwd_b2b_ms:.4f} "
        f"b2b; {bwd_done / bwd_b2b_ms / 1e9:.1f} TFLOP/s done, {bwd_flops / bwd_b2b_ms / 1e9:.1f} needed), "
        f"autograd backward on a retained graph {port_bwd_ms:.4f} ms, plain o/lse backward {bwd_plain_ms:.4f} ms, "
        f"SDPA's backward {library_bwd_ms:.4f} ms ({library_bwd_b2b_ms:.4f} b2b), bound {bb_ms:.4f} ms ({bb_by}: "
        f"{bwd_flops / 1e9:.1f} GFLOP at 989 TFLOP/s), {100 * bb_ms / bwd_ms:.1f} % of the bound; one call's "
        f"device time by kernel (torch.profiler): {split}")
    records["flash_attention"].update({
        "backward": "flash_attention_bwd", "fwd_bwd_ms": ms, "fwd_bwd_b2b_ms": b2b_ms,
        "fwd_bwd_plain_ms": plain_ms, "fwd_bwd_library_ms": library_ms,
        "fwd_bwd_library_b2b_ms": library_b2b_ms, "fwd_bwd_bound_ms": b_ms, "fwd_bwd_max_abs_err": max(errs),
    })
    records["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "jax.grad of src/repro/kernels/flash_attention/ref.py:14 (attention_ref; no Pallas backward)",
        "max_abs_err": err, "ms": bwd_ms, "b2b_ms": bwd_b2b_ms, "autograd_ms": port_bwd_ms,
        "plain_ms": bwd_plain_ms, "bound_ms": bb_ms, "bound_by": bb_by, "library_ms": library_bwd_ms,
        "library_b2b_ms": library_bwd_b2b_ms, "kernel_split_ms": bwd_split,
    }


def _bwd_kernel_split(call):
    """Device milliseconds of each CUDA kernel that one ``call`` runs, by
    ``torch.profiler`` (the backward's three: Delta, the sweep, dQ's
    conversion; the wrapper's zero fills beside them). Empty when the
    profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = {"delta_kernel": "delta", "bwd_wgmma_kernel": "sweep", "dq_convert_kernel": "dq_convert"}
    split = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = next((v for k, v in names.items() if k in e.key), "other")
            split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3
    return split


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


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


class _RecordedRoutes:
    """Within ``with``: every ``moe.route`` call's ``expert_idx`` is kept, in
    call order (one a layer for a forward). Records only references, so the
    forward it wraps waits on nothing."""

    def __init__(self):
        self.expert_idx = []

    def __enter__(self):
        from repro_torch.models import moe

        self._route = route = moe.route

        def recording(p, xf, cfg):
            out = route(p, xf, cfg)
            self.expert_idx.append(out[2])
            return out

        moe.route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route
        return False


def _prefill_decode_gap(cfg, params, toks, dev):
    """Whether the prefill logits over ``toks [1, T]`` are finite, and their
    relative L2 gap to T ``serve_step`` decodes."""
    from repro_torch.models import transformer as tf

    t = toks.shape[1]
    pre, _ = tf.forward(cfg, params, toks)
    cache = tf.init_kv_cache(cfg, 1, t, device=dev)
    dec = torch.stack([tf.serve_step(cfg, params, toks[:, i], cache, i)[0] for i in range(t)], dim=1)
    return bool(torch.isfinite(pre).all()), float((pre.float() - dec.float()).norm() / dec.float().norm())


def _lm_phase(cfg, phase, dev, main_launches):
    """One LM config at full width and depth, random bf16 weights: draw the
    parameters on the card, prefill against token-by-token decode on 16
    tokens, the forward pass and loss over one 4,096-token sequence (the
    ``flash_attention`` main path, one launch a layer; for an MoE config
    each layer's router choices are recorded), then the server on 8
    requests, twice. Returns the parameters, the router choices and the
    phase's JSON record."""
    from repro_torch import kernels
    from repro_torch.data.pipeline import LmDataConfig, lm_token_stream
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import Request, ServingEngine

    name = cfg.name
    torch.cuda.reset_peak_memory_stats()
    params, init_s = once(lambda: tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == cfg.param_count(), f"{name}: {n_params:,} parameters drawn on the card in {init_s:.2f} s "
                                         f"(peak {init_peak / 1e9:.2f} GB)")

    with torch.no_grad():
        # Prefill (through flash_attention) against decode (the cache path)
        # on 16 tokens: the same causal function, so the logits agree to
        # bf16 rounding over every layer. An MoE layer's capacity grows with
        # the tokens of a call, so a prefill may drop assignments that a
        # one-token decode keeps; the check runs at the capacity factor
        # E / k, where no call drops, and the config's own gap is printed.
        toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, size=(1, 16)), device=dev)
        same_fn = cfg
        if cfg.moe:
            same_fn = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        finite, rel = _prefill_decode_gap(same_fn, params, toks, dev)
        what = " (capacity factor E / k: no assignment drops)" if cfg.moe else ""
        check(finite and rel < 0.1,
              f"{name} prefill == token-by-token decode on 16 tokens{what}: relative L2 gap {rel:.4f} < 0.1")
        if cfg.moe:
            with _RecordedRoutes() as prefill_routes:
                _, own_rel = _prefill_decode_gap(cfg, params, toks, dev)
            dropped = sum(_dropped_share(idx, cfg.moe) for idx in prefill_routes.expert_idx[:cfg.n_layers])
            say(f"phase 9: {name} prefill against decode at capacity factor {cfg.moe.capacity_factor}: "
                f"relative L2 gap {own_rel:.4f}; the 16-token prefill dropped "
                f"{dropped * 16 * cfg.moe.top_k:.0f} assignments over the layers")

        batch = next(lm_token_stream(LmDataConfig(vocab=cfg.vocab, seq_len=4096, batch=1, seed=0)))
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with _RecordedRoutes() as routes:
            (logits, aux), fwd_s = once(lambda: tf.forward(cfg, params, tokens))
        counts = kernels.launch_counts()
        _add_counts(main_launches, counts)
        fwd_peak = torch.cuda.max_memory_allocated()
        flash_routes = dict(kernels.KERNELS["flash_attention"].route_launches)
        check(counts["flash_attention"] == cfg.n_layers,
              f"{name} forward over 4096 tokens launched flash_attention {counts['flash_attention']} times "
              f"(one a layer)")
        check(flash_routes == {"wgmma": cfg.n_layers},
              f"every flash_attention launch of the {name} forward took the tensor-core route ({flash_routes})")
        check(tuple(logits.shape) == (1, 4096, cfg.vocab) and bool(torch.isfinite(logits).all()),
              f"{name} logits [1x4096x{cfg.vocab}] are finite")
        aux = float(aux)
        if cfg.moe:
            check(len(routes.expert_idx) == cfg.n_layers and np.isfinite(aux) and aux >= 0,
                  f"{name} forward: aux loss {aux:.5f} is finite and >= 0, router choices of "
                  f"{len(routes.expert_idx)} layers recorded")
        del logits
        _, fwd2_s = once(lambda: tf.forward(cfg, params, tokens))
        loss, loss_s = once(lambda: float(tf.loss_fn(cfg, params, {"tokens": tokens, "labels": labels})))
        check(np.isfinite(loss), f"{name} loss {loss:.4f} is finite (ln V = {np.log(cfg.vocab):.4f})")

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
              f"{name} server answered all 8 requests, 16 tokens each ({serve_s:.2f} s)")
        check(flash == 0, "the server decodes through the cache path and launches no flash_attention")
        runs.append(([r.generated for r in reqs], serve_s))
        del eng
    check(runs[0][0] == runs[1][0], f"{name} server: two runs give the same tokens")
    n_tok = sum(len(g) for g in runs[0][0])
    n_prompt = sum(len(p) for p in prompts)
    record = {
        "phase": phase, "model": name, "parameters": n_params, "init_s": init_s,
        "init_peak_device_bytes": init_peak,
        "forward_tokens": 4096, "forward_first_s": fwd_s, "forward_s": fwd2_s,
        "forward_tokens_per_s": 4096 / fwd2_s, "forward_peak_device_bytes": fwd_peak,
        "loss": loss, "loss_s": loss_s, "flash_attention_launches_per_forward": counts["flash_attention"],
        "serve_requests": 8, "serve_prompt_tokens": n_prompt, "serve_new_tokens": n_tok,
        "serve_s": [r[1] for r in runs], "serve_new_tokens_per_s": [n_tok / r[1] for r in runs],
        "prefill_decode_rel_gap": rel,
    }
    if cfg.moe:
        record["aux_loss"] = aux
    return params, routes.expert_idx, record


def phase5_lm(dev, main_launches):
    """granite-3-8b at ``configs/granite_3_8b.FULL``, all 40 layers."""
    from repro_torch.configs.granite_3_8b import FULL

    params, _, record = _lm_phase(FULL, 5, dev, main_launches)
    del params
    say(json.dumps(record))


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------
#: The other LM configs, smallest first: each is freed before the next is
#: drawn, and yi-34b's weights and draws fill ~71 of the card's 80 GB.
PHASE9_CONFIGS = ("deepseek_moe_16b", "qwen3_moe_30b_a3b", "deepseek_coder_33b", "yi_34b")
PHASE9_RESIDENT_LIMIT = 2e9     # bytes still allocated before a config is drawn
N_GROUPS = 4                    # expert groups of the placement (devices of an EP layout)


def _dropped_share(expert_idx, cfg) -> float:
    """Share of one layer's top-k assignments past their expert's capacity."""
    from repro_torch.models.moe import capacity

    n = expert_idx.shape[0]
    counts = torch.bincount(expert_idx.reshape(-1), minlength=cfg.n_experts)
    return float((counts - capacity(n, cfg)).clamp_min(0).sum()) / (n * cfg.top_k)


def _placement(cfg, expert_idx, dev):
    """DiDiC expert placement from one layer's router choices over the
    4,096 tokens: co-location of DiDiC's groups, of the balanced groups its
    permutation lays out (E/4 experts each, as an expert-parallel layout
    needs) and of the naive ``arange(E) % 4``."""
    from repro_torch.distributed.expert_placement import (
        co_location_fraction, coactivation_graph, didic_expert_groups, expert_permutation,
    )

    idx = expert_idx.cpu().numpy()
    e = cfg.n_experts
    graph = coactivation_graph(idx, e)
    groups, didic_s = once(lambda: didic_expert_groups(graph, N_GROUPS, seed=0, device=dev))
    perm = expert_permutation(groups, N_GROUPS)
    check(perm.shape == (e,) and sorted(perm.tolist()) == list(range(e)),
          f"expert_permutation is a permutation of {e} experts, {e // N_GROUPS} a group")
    balanced = np.empty(e, dtype=np.int64)
    balanced[perm] = np.arange(e) // (e // N_GROUPS)   # the group each expert's slot falls in
    return {"edges": graph.n_edges, "didic_s": didic_s,
            "group_sizes": np.bincount(groups, minlength=N_GROUPS).tolist(),
            "co_location_didic": co_location_fraction(idx, groups),
            "co_location_balanced": co_location_fraction(idx, balanced),
            "co_location_naive": co_location_fraction(idx, np.arange(e) % N_GROUPS)}


def _moe_layer_timing(cfg, params, dev):
    """``moe_fwd`` alone at ``[1, 4096, d_model]`` bf16 with layer 0's
    weights: one call and 10 back to back, two calls' bits, and the bound:
    every weight read once, x read and y written once, against the
    operations of the capacity buffer (what the layer computes: E · C
    slots), the shared experts and the router; and against the kept
    assignments' operations alone."""
    from repro_torch.models.moe import capacity, moe_fwd, route
    from repro_torch.models.transformer import layer_params

    m, d, n = cfg.moe, cfg.d_model, 4096
    p = layer_params(params, 0)["moe"]
    x = torch.randn((1, n, d), generator=torch.Generator(device=dev).manual_seed(5), device=dev).to(cfg.dtype)
    with torch.no_grad():
        ms, (y, _) = time_cuda(lambda: moe_fwd(p, x, m))
        b2b_ms = time_cuda(lambda: moe_fwd(p, x, m), inner=B2B)[0]
        check(torch.equal(y, moe_fwd(p, x, m)[0]) and bool(torch.isfinite(y).all()),
              f"{cfg.name} moe_fwd [1x{n}x{d}]: finite, and two calls give the same bits")
        idx = route(p, x.reshape(n, d), m)[2]
    cap = capacity(n, m)
    kept = int(torch.bincount(idx.reshape(-1), minlength=m.n_experts).clamp_max(cap).sum())
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(p)) + 2 * n * d * x.element_size()
    per_slot = 6.0 * d * m.d_ff                     # gate, up and down products, 2 operations a multiply-add
    other = 6.0 * n * d * m.d_ff * m.n_shared + 2.0 * n * d * m.n_experts
    b_ms, b_by = bound_ms(n_bytes, m.n_experts * cap * per_slot + other, PEAK_BF16_FLOPS)
    kept_ms, kept_by = bound_ms(n_bytes, kept * per_slot + other, PEAK_BF16_FLOPS)
    say(f"phase 9: {cfg.name} moe_fwd [1x{n}x{d}] bf16, {m.n_experts} experts x {cap} slots, top-{m.top_k}, "
        f"{m.n_shared} shared: {ms:.4f} ms one call, {b2b_ms:.4f} ms a call over {B2B} back to back; bound "
        f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e9:.3f} GB, {(m.n_experts * cap * per_slot + other) / 1e9:.1f} "
        f"GFLOP), {100 * b_ms / b2b_ms:.1f} % of it b2b; kept assignments only ({kept} of {n * m.top_k}): "
        f"{kept_ms:.4f} ms ({kept_by})")
    return {"ms": ms, "b2b_ms": b2b_ms, "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "capacity": cap, "kept_assignments": kept, "kept_bound_ms": kept_ms, "kept_bound_by": kept_by}


def phase9_lm(module, dev, main_launches):
    """One of the other LM configs at full width and depth (``_lm_phase``);
    for an MoE config also the dropped share, the expert placement from
    layer 0's and the last layer's router choices, and the MoE layer's time
    against its bound."""
    import gc
    import importlib

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    cfg = importlib.import_module(f"repro_torch.configs.{module}").FULL
    check(resident < PHASE9_RESIDENT_LIMIT,
          f"phase 9: {resident:,} bytes allocated on the card before {cfg.name} is drawn (< 2 GB)")
    params, expert_idx, record = _lm_phase(cfg, 9, dev, main_launches)
    if cfg.moe:
        shares = [_dropped_share(idx, cfg.moe) for idx in expert_idx]
        say(f"phase 9: {cfg.name} assignments dropped at capacity factor {cfg.moe.capacity_factor} over 4096 "
            f"tokens: {100 * float(np.mean(shares)):.3f} % over the layers (layer {int(np.argmax(shares))} "
            f"most, {100 * max(shares):.3f} %)")
        record["dropped_share_per_layer"] = shares
        record["placement"] = {}
        for layer in (0, cfg.n_layers - 1):
            pl = _placement(cfg.moe, expert_idx[layer], dev)
            say(f"phase 9: {cfg.name} layer {layer} expert placement in {N_GROUPS} groups: co-location "
                f"DiDiC {pl['co_location_didic']:.4f}, its balanced permutation {pl['co_location_balanced']:.4f}, "
                f"naive {pl['co_location_naive']:.4f} "
                f"(groups {pl['group_sizes']}, {pl['edges']} co-activation edges, DiDiC {pl['didic_s']:.2f} s)")
            record["placement"][str(layer)] = pl
        record["moe_layer"] = _moe_layer_timing(cfg, params, dev)
    say(f"phase 9: {cfg.name}: forward over 4096 tokens {record['forward_s']:.4f} s "
        f"({record['forward_tokens_per_s']:.0f} tokens/s), peak {record['forward_peak_device_bytes'] / 1e9:.2f} GB; "
        f"server {', '.join(f'{r:.1f}' for r in record['serve_new_tokens_per_s'])} new tokens/s")
    del params, expert_idx
    say(json.dumps(record))


def phase9_top_k_ties(dev):
    """What ``torch.topk`` does with tied values on the card, beside the
    port's stable top-k (ties to the lower index, as ``jax.lax.top_k``)."""
    from repro_torch.models.moe import top_k

    x = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]], device=dev)
    lib = torch.topk(x, 3).indices.tolist()[0]
    ours = top_k(x, 3)[1].tolist()[0]
    check(ours == [1, 2, 4], f"the port's top-k breaks ties to the lower index on the card ({ours})")
    say(f"phase 9: torch.topk on the card, top 3 of [.1, .3, .3, .2, .3]: {lib}; the port's top_k: {ours}")


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------
TRAIN_DEPTHS = (16, 12, 8)      # phase 10a's depths, largest first: one card holds no more
TRAIN_PEAK_LIMIT = 76e9         # bytes a depth's training step may peak at (of the card's 80 GB)
TRAIN_PROBE_DEPTHS = (4, 8)     # one step each: the peak's line over the depth
TRAIN_STEPS = 5
# Adam's first step moves every weight by about lr·sign(g), coherently over
# 4,096-wide products: at 3e-4 (the optimizer's default) the loss of the
# 12-layer model rose after the first step, so did it at 1e-4 and 3e-5;
# 1e-5 lowers it every step on the repeated batch.
TRAIN_LR = 1e-5
LAUNCH_STEPS = 20               # phase 10b: steps of each training launcher (cut from 40 for time)
LAUNCH_FAULT_STEP = 10
LAUNCH_ARCHS = ("granite-3-8b", "yi-34b", "deepseek-coder-33b", "deepseek-moe-16b", "qwen3-moe-30b-a3b", "din")
LOSS_RTOL = 1e-5                # tests/test_torch_train.py LOSS_RTOL: the trainer against the JAX trainer
MOE_LOSS_RTOL = 1e-2            # tests/test_torch_train.py MOE_LOSS_RTOL: the same with top-k routing


def _granite_train_cfg(depth):
    """granite-3-8b at ``depth`` layers, remat off: the step phase 10 has
    always measured (no launch in the backward; phase 17 runs remat)."""
    from repro_torch.configs.granite_3_8b import FULL

    return dataclasses.replace(FULL, name=f"granite-3-8b-{depth}L", n_layers=depth, remat=False)


def _granite_trainer(cfg, dev, steps):
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return Trainer(lambda p, b: tf.loss_fn(cfg, p, b), params,
                   AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps),
                   TrainerConfig(total_steps=steps, log_every=1))


def _probe_peak(depth, batch, dev) -> int:
    """Peak device bytes of one training step of granite at ``depth``."""
    import gc
    import itertools

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _granite_trainer(_granite_train_cfg(depth), dev, 1)
    tr.fit(itertools.repeat(batch))
    peak = torch.cuda.max_memory_allocated()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def _train_depth(batch, dev):
    """The largest of ``TRAIN_DEPTHS`` whose peak stays under
    ``TRAIN_PEAK_LIMIT``: each probe depth's peak is measured, and the peak
    is linear in the depth (parameters, moments, gradients and activations
    all grow by one layer's worth a layer), so the line through the probes
    gives the others. The chosen depth's own peak is checked after its run."""
    peaks = {d: _probe_peak(d, batch, dev) for d in TRAIN_PROBE_DEPTHS}
    (d0, p0), (d1, p1) = sorted(peaks.items())
    per_layer = (p1 - p0) / (d1 - d0)
    predicted = {d: peaks.get(d, p1 + (d - d1) * per_layer) for d in TRAIN_DEPTHS}
    depth = next((d for d in TRAIN_DEPTHS if predicted[d] < TRAIN_PEAK_LIMIT), None)
    say(f"phase 10: granite-3-8b training peak, measured: " + ", ".join(f"{d} layers {p / 1e9:.2f} GB"
                                                                     for d, p in sorted(peaks.items()))
        + f"; {per_layer / 1e9:.3f} GB a layer; predicted " + ", ".join(
            f"{d} layers {predicted[d] / 1e9:.2f} GB" for d in TRAIN_DEPTHS))
    check(depth is not None, f"phase 10: a depth of {TRAIN_DEPTHS} trains under {TRAIN_PEAK_LIMIT / 1e9:.0f} GB")
    return depth, peaks, predicted


def _select_backward_cost(layers, dev):
    """What indexing the stacked ``[L, ...]`` parameters costs the backward:
    for each layer's use, ``SelectBackward`` writes a zero gradient of the
    whole stack with the layer's slice copied in, and autograd adds it into
    the stack's gradient. This replays those operations on the stacked
    leaves (the layer's own values as its gradient), by CUDA events, beside
    the L slice copies a per-layer layout would need."""
    from repro_torch.optim.adamw import leaves

    def replay():
        for t in leaves(layers):
            acc = None
            for i in range(t.shape[0]):
                full = torch.zeros_like(t)
                full[i].copy_(t[i])
                acc = full if acc is None else acc.add_(full)
            del acc

    def sliced():
        for t in leaves(layers):
            out = torch.empty_like(t)
            for i in range(t.shape[0]):
                out[i].copy_(t[i])

    n = next(iter(leaves(layers))).shape[0]
    stack_bytes = sum(t.numel() * t.element_size() for t in leaves(layers))
    replay_ms = time_cuda(replay, reps=3, warmup=1)[0]
    sliced_ms = time_cuda(sliced, reps=3, warmup=1)[0]
    # Bytes: each use writes the whole zero stack, and the add reads two and
    # writes one (the first use's stack becomes the sum): 4 stacks a use, less 3 once.
    moved = (4 * n - 3) * stack_bytes
    return {"layers": n, "stack_bytes": stack_bytes, "replay_ms": replay_ms, "slice_copies_ms": sliced_ms,
            "replay_bytes": moved}


def phase10_granite(dev, main_launches):
    """granite-3-8b at full width, bf16, depth cut as one card forces:
    ``TRAIN_STEPS`` trainer steps on one 4,096-token sequence repeated, then
    one more step split into forward, backward and update by CUDA events,
    whose gradients are checked."""
    import gc
    import itertools

    from repro_torch import kernels
    from repro_torch.data.pipeline import LmDataConfig, lm_token_stream
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    check(resident < PHASE9_RESIDENT_LIMIT,
          f"phase 10: {resident:,} bytes allocated on the card before granite is drawn for training (< 2 GB)")
    raw = next(lm_token_stream(LmDataConfig(vocab=49_155, seq_len=4096, batch=1)))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    depth, probe_peaks, predicted = _train_depth(batch, dev)
    cfg = _granite_train_cfg(depth)
    say(f"phase 10: granite-3-8b trained at full width (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads, Dh {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}), depth cut from 40 to {depth} "
        f"layers ({cfg.param_count():,} parameters): AdamW's float32 moments and a pure step (old and new state "
        f"alive at the update, 22 B a parameter) do not fit 40 layers on one 80 GB card")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _granite_trainer(cfg, dev, TRAIN_STEPS)
    kernels.reset_launch_counts()
    tr.fit(itertools.repeat(batch))
    counts = kernels.launch_counts()
    routes = dict(kernels.KERNELS["flash_attention"].route_launches)
    _add_counts(main_launches, counts)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in tr.metrics_log]
    step_s = [m["step_time_s"] for m in tr.metrics_log]
    n_steps = TRAIN_STEPS + tr.straggler.redispatches
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"phase 10: {TRAIN_STEPS} steps, every loss finite ({', '.join(f'{x:.4f}' for x in losses)})")
    check(losses[-1] < losses[0], f"phase 10: the loss at step {TRAIN_STEPS} ({losses[-1]:.4f}) is below step 1's "
                                  f"({losses[0]:.4f})")
    bwd_routes = dict(kernels.KERNELS["flash_attention_bwd"].route_launches)
    check(counts["flash_attention"] == depth * n_steps and routes == {"wgmma": depth * n_steps},
          f"phase 10: flash_attention launched {counts['flash_attention']} times in {n_steps} steps, one a layer, "
          f"all on the tensor-core route ({routes})")
    check(counts["flash_attention_bwd"] == depth * n_steps and bwd_routes == {"wgmma": depth * n_steps},
          f"phase 10: flash_attention_bwd launched {counts['flash_attention_bwd']} times in {n_steps} steps, one a "
          f"layer in each backward, all on wgmma ({bwd_routes})")
    check(peak < TRAIN_PEAK_LIMIT, f"phase 10: training peak {peak / 1e9:.2f} GB at {depth} layers "
                                   f"(< {TRAIN_PEAK_LIMIT / 1e9:.0f} GB; predicted {predicted[depth] / 1e9:.2f})")
    check(peak < 80e9, f"phase 10: training peak {peak / 1e9:.2f} GB under the card's 80 GB")
    median_s = statistics.median(step_s)
    say(f"phase 10: granite-3-8b {depth} layers, {TRAIN_STEPS} steps of 4096 tokens: step s "
        f"{', '.join(f'{x:.4f}' for x in step_s)}; median {median_s:.4f} s, {4096 / median_s:.0f} tokens/s; "
        f"peak {peak:,} B")

    # One more step, split by CUDA events; its gradients are checked.
    state, opt_cfg = tr.state, tr.opt_cfg
    del tr
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True), state["params"])
    kernels.reset_launch_counts()
    ev[0].record()
    loss = tf.loss_fn(cfg, live, batch)
    ev[1].record()
    fwd_flash = kernels.launch_counts()["flash_attention"]
    grads = torch.autograd.grad(loss, list(adamw.leaves(live)))
    ev[2].record()
    bwd_flash = kernels.launch_counts()["flash_attention"] - fwd_flash
    bwd_kernel = kernels.launch_counts()["flash_attention_bwd"]
    grad_tree = adamw.tree_unflatten(live, grads)
    del live, loss
    new_state = adamw.update(state["params"], grad_tree, state["opt"], opt_cfg)
    ev[3].record()
    ev[3].synchronize()
    fwd_ms, bwd_ms, upd_ms = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    del new_state
    check(fwd_flash == depth and bwd_flash == 0 and bwd_kernel == depth,
          f"phase 10: the split step's forward launched flash_attention {fwd_flash} times, its backward "
          f"{bwd_flash} times and flash_attention_bwd {bwd_kernel} times")
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"phase 10: all {len(grads)} gradient leaves finite")
    nonzero = {w: [bool(x) for x in (grad_tree["layers"]["attn"][w].float().abs().amax(dim=(1, 2)) > 0).tolist()]
               for w in ("wq", "wk", "wv")}
    check(all(all(v) for v in nonzero.values()),
          f"phase 10: the gradients of wq, wk and wv are non-zero in every one of the {depth} layers")
    del grads, grad_tree
    gc.collect()
    torch.cuda.empty_cache()
    select = _select_backward_cost(state["params"]["layers"], dev)
    say(f"phase 10: one step split by CUDA events: forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms, AdamW update "
        f"{upd_ms:.2f} ms; SelectBackward on the stacked layers, replayed: {select['replay_ms']:.2f} ms "
        f"({select['replay_bytes'] / 1e9:.1f} GB moved, a {select['stack_bytes'] / 1e9:.2f} GB stack), against "
        f"{select['slice_copies_ms']:.2f} ms for the per-layer slices alone")
    del state
    say(json.dumps({
        "phase": 10, "model": cfg.name, "depth": depth, "parameters": cfg.param_count(), "tokens": 4096,
        "losses": losses, "step_s": step_s, "median_step_s": median_s, "tokens_per_s": 4096 / median_s,
        "peak_device_bytes": peak, "probe_peak_device_bytes": probe_peaks,
        "predicted_peak_device_bytes": predicted, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
        "update_ms": upd_ms, "flash_attention_launches": counts["flash_attention"],
        "flash_attention_bwd_launches": counts["flash_attention_bwd"],
        "select_backward": select,
    }))


def phase10_launchers(dev, main_launches):
    """``launch.train`` on the card for the five LM archs and DIN,
    ``LAUNCH_STEPS`` steps each with a checkpoint directory under ``build/``
    and a fault injected at step ``LAUNCH_FAULT_STEP``; the same launcher on
    the CPU in the same phase, whose losses the card's must equal."""
    import shutil

    from repro_torch import kernels
    from repro_torch.launch.serve import ARCHS
    from repro_torch.launch.train import RUNNERS
    from repro_torch.train.fault import FaultInjector

    out = {}
    for arch in LAUNCH_ARCHS:
        runs = {}
        for device in ("cuda", "cpu"):
            ckpt_dir = os.path.join(ROOT, "build", "phase10_ckpt", f"{arch}-{device}")
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            run = RUNNERS[ARCHS[arch][0]]
            if device == "cuda":
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            tr = run(arch, LAUNCH_STEPS, ckpt_dir, device=dev if device == "cuda" else "cpu",
                     fault_injector=FaultInjector(fail_at_steps=(LAUNCH_FAULT_STEP,)))
            wall = time.perf_counter() - t0
            if device == "cuda":
                counts = kernels.launch_counts()
                _add_counts(main_launches, counts)
            runs[device] = (tr, wall)
            check(tr.step == LAUNCH_STEPS and tr.recoveries == 1
                  and f"ckpt_{LAUNCH_STEPS:08d}.manifest.json" in os.listdir(ckpt_dir),
                  f"phase 10: launch.train {arch} on {device}: recovered from the fault at step {LAUNCH_FAULT_STEP} "
                  f"and ended at step {LAUNCH_STEPS} with its checkpoint ({wall:.2f} s)")
            shutil.rmtree(ckpt_dir)
        card, cpu = runs["cuda"][0], runs["cpu"][0]
        losses = [m["loss"] for m in card.metrics_log]
        cpu_losses = [m["loss"] for m in cpu.metrics_log]
        first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
        check(all(np.isfinite(losses)) and last < first,
              f"phase 10: launch.train {arch} on the card: mean loss of the last 3 logged steps {last:.4f} < "
              f"the first 3's {first:.4f}")
        moe = arch in ("deepseek-moe-16b", "qwen3-moe-30b-a3b")
        rtol = MOE_LOSS_RTOL if moe else LOSS_RTOL
        gap = float(np.max(np.abs(np.array(losses) - cpu_losses) / np.abs(cpu_losses)))
        check(len(losses) == len(cpu_losses) and gap <= rtol,
              f"phase 10: launch.train {arch}: the card's {len(losses)} logged losses equal the CPU's within "
              f"{rtol:g} relative (largest gap {gap:.3g})")
        steps_run = LAUNCH_STEPS + card.straggler.redispatches
        if ARCHS[arch][0] == "lm":
            routes = dict(kernels.KERNELS["flash_attention"].route_launches)
            bwd_routes = dict(kernels.KERNELS["flash_attention_bwd"].route_launches)
            check(counts["flash_attention"] == 4 * steps_run and routes == {"ffma": 4 * steps_run},
                  f"phase 10: launch.train {arch}: {counts['flash_attention']} flash_attention launches on the "
                  f"float32 route, 4 layers x {steps_run} steps")
            check(counts["flash_attention_bwd"] == 4 * steps_run and bwd_routes == {"ffma": 4 * steps_run},
                  f"phase 10: launch.train {arch}: {counts['flash_attention_bwd']} flash_attention_bwd launches on "
                  f"the float32 route ({bwd_routes}), 4 layers x {steps_run} steps")
        out[arch] = {"card_s": runs["cuda"][1], "cpu_s": runs["cpu"][1], "losses": losses,
                     "cpu_losses": cpu_losses, "max_rel_gap": gap, "recoveries": card.recoveries,
                     "redispatches": card.straggler.redispatches, "launches": counts}
        say(f"phase 10: launch.train {arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, card {runs['cuda'][1]:.2f} s, "
            f"CPU {runs['cpu'][1]:.2f} s, card == CPU within {gap:.3g}")
    say(json.dumps({"phase": 10, "launchers": out}))


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------
GNN_ARCHS = ("gcn-cora", "graphsage-reddit", "meshgraphnet", "mace")
# Each arch's graph at GNN_SCALE: at 1.0 cora's 2,708 nodes, reddit's
# 232,965 (Twitter-like, so far fewer than its 114.6 M edges), a 64x64 mesh,
# 128 molecules of 30 atoms.
GNN_DATA = {"gcn-cora": "cora_like", "graphsage-reddit": "reddit_like", "meshgraphnet": "mesh", "mace": "molecules"}
GNN_SCALE = 1.0
GNN_STEPS = 5                   # phase 11a's trainer steps (cut)
# Adam's first step moves every weight by about the learning rate: at the
# launcher's 5e-3, and at 1e-3, the 15-block MeshGraphNet's loss rose after
# that step (a CPU rehearsal); at 1e-4 every FULL config's loss falls.
GNN_LR = 1e-4
# The card against the CPU: the segment sums are bit-equal (the
# segment_sum kernel adds in the CPU's order), the matmuls sum in another
# order. A second card run, and a faulted run against an uninterrupted one,
# must give the same bits.
GNN_CARD_RTOL = 1e-4
# Phase 11b's bar on all 40 logged-step losses, card against CPU, past the
# first (held to GNN_CARD_RTOL). MeshGraphNet: a ReLU input within float32
# rounding of zero parts two runs (tests/test_torch_gnn.py DRIFT_RTOL);
# MACE's launcher run amplifies rounding tenfold a step while it overshoots
# (tests/test_torch_mace.py), so after its first logged step its card and
# CPU runs are not comparable and are checked only to fall.
GNN_LAUNCH_RTOL = {"gcn-cora": GNN_CARD_RTOL, "graphsage-reddit": GNN_CARD_RTOL, "meshgraphnet": 1e-2,
                   "mace": None}


def _gnn_full(arch, dev):
    """``arch``'s ``FULL`` config, its weights drawn on the CPU from seed 0,
    its graph and whole-graph batch (CPU tensors), and the DiDiC seconds:
    labels are ``parts % d_out`` of a DiDiC partition (k=4, 30 iterations,
    the launcher's) run on the card; MACE fits seeded random energies."""
    import importlib

    from repro_torch.core.didic import DidicConfig, didic_partition
    from repro_torch.data.pipeline import gnn_features
    from repro_torch.graphs import datasets
    from repro_torch.launch.serve import ARCHS
    from repro_torch.models import gnn, mace

    cfg = importlib.import_module(ARCHS[arch][1]).FULL
    g = datasets.load(GNN_DATA[arch], scale=GNN_SCALE)
    gen = torch.Generator().manual_seed(0)
    didic_s = 0.0
    if arch == "mace":
        params = mace.init(cfg, gen, device="cpu")
        n_mols = int(g.node_attrs["mol_id"].max()) + 1
        batch = {k: g.node_attrs[k] for k in ("species", "pos", "mol_id")}
        batch.update(senders=g.senders, receivers=g.receivers,
                     target=np.random.default_rng(0).normal(size=n_mols).astype(np.float32))
    else:
        (parts, _), didic_s = once(lambda: didic_partition(g, DidicConfig(k=4, iterations=30), seed=0,
                                                           device=dev))
        x, labels = gnn_features(g.n_nodes, cfg.d_in, cfg.d_out, parts_hint=parts)
        s, r, _ = g.undirected
        params = gnn.init(cfg, gen, device="cpu")
        batch = {"x": x, "labels": labels, "senders": s, "receivers": r}
        if cfg.kind == "meshgraphnet":
            batch["edge_feat"] = torch.randn((s.shape[0], cfg.d_edge_in), generator=torch.Generator().manual_seed(3))
    return cfg, g, params, {k: torch.as_tensor(v) for k, v in batch.items()}, didic_s


def _rel_gap(a, b) -> float:
    return float(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30))


def phase11_gnn(arch, dev, smi, main_launches):
    """``arch`` at its ``FULL`` width on its ``GNN_DATA`` graph: one forward
    (graphsage-reddit: a sampled 1,024-node batch, fanout 15-10, and the
    full graph once) held to the CPU and, bit for bit, to a second card
    run, then ``GNN_STEPS`` trainer steps (graphsage-reddit: a new sampled
    batch a step), a main-path run through ``segment_sum``; MACE's
    energies also under a rotation; graphsage-reddit's sampled block also
    as a ``segment_sum`` kernel check."""
    import gc
    import itertools

    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.launch.train import gnn_loss, sage_sampled_batch
    from repro_torch.models import mace
    from repro_torch.optim.adamw import AdamWConfig, leaves, tree_map
    from repro_torch.train import Trainer, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, g, p_cpu, b_cpu, didic_s = _gnn_full(arch, dev)
    params = tree_map(lambda t: t.to(dev), p_cpu)
    b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
    setup_s = time.perf_counter() - t0
    loss_fn = lambda p, b: gnn_loss(cfg, p, b)  # noqa: E731
    n_items = g.n_nodes
    record = {"phase": 11, "arch": arch, "card": smi, "nodes": g.n_nodes, "edges": int(b_cpu["senders"].shape[0]),
              "parameters": sum(t.numel() for t in leaves(p_cpu)), "setup_s": setup_s, "didic_s": didic_s}
    if arch == "graphsage-reddit":
        shape = GNN_SHAPES["minibatch_lg"]
        ns = NeighborSampler(g, shape["fanout"], seed=0)
        batches = [sage_sampled_batch(ns.sample_batch(nodes), b_dev["x"], b_dev["labels"])
                   for nodes in ns.batches(shape["batch_nodes"], GNN_STEPS, seed=1)]
        fwd_batch, data = batches[0], iter(batches)
        n_items = shape["batch_nodes"]
        record["sampled_rows"] = [int(b["feats"].shape[0]) for b in batches]
        with torch.no_grad():
            full_dev, full_s = once(lambda: loss_fn(params, b_dev))
            full_cpu = loss_fn(p_cpu, b_cpu)
        check(bool(torch.isfinite(full_dev)) and _rel_gap(full_dev, full_cpu) <= GNN_CARD_RTOL,
              f"phase 11: {arch} full-graph forward ({g.n_nodes:,} nodes, {record['edges']:,} edges): loss "
              f"{float(full_dev):.6f} on the card, {float(full_cpu):.6f} on the CPU (gap {_rel_gap(full_dev, full_cpu):.3g})")
        record["full_forward_ms"] = full_s * 1e3
    else:
        fwd_batch, data = b_dev, itertools.repeat(b_dev)
    with torch.no_grad():
        fwd_ms, loss_dev = time_cuda(lambda: loss_fn(params, fwd_batch), reps=5, warmup=1)
        b2b_ms = time_cuda(lambda: loss_fn(params, fwd_batch), reps=3, warmup=0, inner=B2B)[0]
        again = loss_fn(params, fwd_batch)
        loss_cpu = loss_fn(p_cpu, {k: v.cpu() for k, v in fwd_batch.items()})
    gaps = (_rel_gap(loss_dev, loss_cpu), _rel_gap(again, loss_dev))
    check(bool(torch.isfinite(loss_dev)) and gaps[0] <= GNN_CARD_RTOL and _bits_equal(again, loss_dev),
          f"phase 11: {arch} forward loss {float(loss_dev):.6f} on the card, {float(loss_cpu):.6f} on the CPU "
          f"(gap {gaps[0]:.3g}, bar {GNN_CARD_RTOL:g}); a second card run bit-equal")
    if arch == "graphsage-reddit":
        # the inner block's gather backward: its gradient [T·fanout, d] summed into the block's sources
        nbrs = fwd_batch["nbrs1"]
        grad = torch.as_tensor(np.random.default_rng(6).standard_normal((nbrs.numel(), cfg.d_hidden))
                               .astype(np.float32), device=dev)
        record["segment_sum_block"] = segment_sum_case(
            grad, nbrs, int(fwd_batch["nbrs0"].shape[0]), "a sampled GraphSAGE block's gather backward", dev)
    if arch == "mace":
        q, _ = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))
        q[:, 0] *= np.sign(np.linalg.det(q))
        args = [b_dev[k] for k in ("species", "pos", "senders", "receivers", "mol_id")]
        with torch.no_grad():
            e, _ = mace.forward(cfg, params, *args, b_dev["target"].shape[0])
            args[1] = args[1] @ torch.as_tensor(q.astype(np.float32), device=dev)
            e_rot, _ = mace.forward(cfg, params, *args, b_dev["target"].shape[0])
        rot = float((e_rot - e).abs().max() / e.abs().max())
        check(rot <= 1e-4, f"phase 11: mace energies of rotated positions within {rot:.3g} of the originals "
                           f"(relative to the largest, bar 1e-4)")
        record["rotation_gap"] = rot

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(loss_fn, params, AdamWConfig(lr=GNN_LR, warmup_steps=1, total_steps=GNN_STEPS, weight_decay=0.0),
                 TrainerConfig(total_steps=GNN_STEPS, log_every=1))
    _, counts = _counted(lambda: tr.fit(data), main_launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in tr.metrics_log]
    step_s = [m["step_time_s"] for m in tr.metrics_log]
    check(len(losses) == GNN_STEPS and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"phase 11: {arch} {GNN_STEPS} trainer steps, losses finite, step {GNN_STEPS}'s below step 1's "
          f"({', '.join(f'{x:.4f}' for x in losses)})")
    check(counts["segment_sum"] > 0 and not any(n for k, n in counts.items() if k != "segment_sum"),
          f"phase 11: {arch}'s {GNN_STEPS} steps summed through segment_sum ({counts['segment_sum']} launches) "
          f"and launched no other kernel")
    median_s = statistics.median(step_s)
    record.update({
        "forward_ms": fwd_ms, "forward_b2b_ms": b2b_ms, "loss": float(loss_dev), "loss_cpu": float(loss_cpu), "card_cpu_gap": gaps[0],
        "card_card_gap": gaps[1], "losses": losses, "step_ms": [x * 1e3 for x in step_s],
        "median_step_ms": median_s * 1e3, "items_per_s_forward": n_items / (fwd_ms / 1e3),
        "items_per_s_step": n_items / median_s, "peak_device_bytes": peak,
        "redispatches": tr.straggler.redispatches, "launches": counts,
    })
    say(f"phase 11: {arch} ({cfg.name}, {record['parameters']:,} parameters; {g.n_nodes:,} nodes): forward "
        f"{fwd_ms:.3f} ms, {b2b_ms:.3f} b2b ({record['items_per_s_forward']:,.0f} "
        f"{'atoms' if arch == 'mace' else 'nodes'}/s), step "
        f"{median_s * 1e3:.3f} ms median, peak {peak:,} B")
    del tr, params, b_dev, fwd_batch, data
    say(json.dumps(record))


def phase11_launchers(dev, smi):
    """``launch.train`` on the card and on the CPU for the four GNN archs,
    ``LAUNCH_STEPS`` steps each with a checkpoint directory under ``build/``
    and a fault at step ``LAUNCH_FAULT_STEP`` (the labels' DiDiC map drawn
    once an arch, on the CPU, as the launcher draws it); the faulted card run
    bit-equal to an uninterrupted card run (every logged loss and the final
    parameters: the reference's bit-exact resume)."""
    import shutil

    from repro_torch.launch.train import gnn_parts, train_gnn
    from repro_torch.optim.adamw import leaves
    from repro_torch.train.fault import FaultInjector

    out = {}
    for arch in GNN_ARCHS:
        parts = None if arch == "mace" else gnn_parts(arch)
        runs = {}
        for device in ("cuda", "cpu"):
            ckpt_dir = os.path.join(ROOT, "build", "phase11_ckpt", f"{arch}-{device}")
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            t0 = time.perf_counter()
            tr = train_gnn(arch, LAUNCH_STEPS, ckpt_dir, device=dev if device == "cuda" else "cpu",
                           fault_injector=FaultInjector(fail_at_steps=(LAUNCH_FAULT_STEP,)), parts=parts)
            wall = time.perf_counter() - t0
            runs[device] = (tr, wall)
            check(tr.step == LAUNCH_STEPS and tr.recoveries == 1
                  and f"ckpt_{LAUNCH_STEPS:08d}.manifest.json" in os.listdir(ckpt_dir),
                  f"phase 11: launch.train {arch} on {device}: recovered from the fault at step {LAUNCH_FAULT_STEP} "
                  f"and ended at step {LAUNCH_STEPS} with its checkpoint ({wall:.2f} s)")
            shutil.rmtree(ckpt_dir)
        t0 = time.perf_counter()
        whole = train_gnn(arch, LAUNCH_STEPS, None, device=dev, parts=parts)
        whole_s = time.perf_counter() - t0
        faulted = runs["cuda"][0]
        check([m["loss"] for m in faulted.metrics_log] == [m["loss"] for m in whole.metrics_log]
              and all(map(_bits_equal, leaves(faulted.state["params"]), leaves(whole.state["params"]))),
              f"phase 11: launch.train {arch} on the card: the run recovered from the fault == an uninterrupted "
              f"run ({whole_s:.2f} s), every logged loss and every final parameter bit for bit")
        losses = [m["loss"] for m in runs["cuda"][0].metrics_log]
        cpu_losses = [m["loss"] for m in runs["cpu"][0].metrics_log]
        first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
        check(all(np.isfinite(losses)) and last < first,
              f"phase 11: launch.train {arch} on the card: mean loss of the last 3 logged steps {last:.4f} < "
              f"the first 3's {first:.4f}")
        gaps = [_rel_gap(a, b) for a, b in zip(losses, cpu_losses)]
        rtol = GNN_LAUNCH_RTOL[arch]
        check(len(losses) == len(cpu_losses) and gaps[0] <= GNN_CARD_RTOL and (rtol is None or max(gaps) <= rtol),
              f"phase 11: launch.train {arch}: the card's first logged loss within {gaps[0]:.3g} of the CPU's "
              f"(bar {GNN_CARD_RTOL:g}); over all {len(losses)} at most {max(gaps):.3g} apart (bar {rtol})")
        out[arch] = {"card_s": runs["cuda"][1], "cpu_s": runs["cpu"][1], "uninterrupted_s": whole_s,
                     "losses": losses, "cpu_losses": cpu_losses,
                     "rel_gaps": gaps, "recoveries": runs["cuda"][0].recoveries,
                     "redispatches": runs["cuda"][0].straggler.redispatches}
        say(f"phase 11: launch.train {arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, card {runs['cuda'][1]:.2f} s, "
            f"CPU {runs['cpu'][1]:.2f} s, gaps {gaps[0]:.3g} first, {max(gaps):.3g} largest")
    say(json.dumps({"phase": 11, "card": smi, "launchers": out}))


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------
PHASE12_BUDGET_S = 60.0
# Phase 12's GIS log: at most the first 1,000 ops of phase 6's log (all of
# its 500). Cut because the script passed 1,050 s (PERF.md §4); never cut
# graph scale.
PHASE12_GIS_OPS = 1_000
PHASE12_SLICE = 0.0005  # the structural slice: a partial redo inside the budget


def _open_nccl_world1():
    """A one-rank NCCL group over a ``HashStore`` on ``cuda:0``."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)


def _damaged(parts, k, seed):
    rng = np.random.default_rng(seed)
    out = parts.copy()
    idx = rng.choice(parts.shape[0], size=parts.shape[0] // 4, replace=False)
    out[idx] = rng.integers(0, k, size=idx.shape[0])
    return out


def _keep_mesh_states(fn):
    """``fn()`` and the final diffusion state of every mesh DiDiC run inside
    it (``didic_partition_distributed`` returns the map only; its loads
    ``w`` are this rank's block of the state ``_run_mesh`` returns)."""
    from repro_torch.core import didic_distributed

    states, run_mesh = [], didic_distributed._run_mesh

    def keep(*args, **kwargs):
        states.append(run_mesh(*args, **kwargs))
        return states[-1]

    didic_distributed._run_mesh = keep
    try:
        return fn(), states
    finally:
        didic_distributed._run_mesh = run_mesh


def phase12(held, dev, smi, main_launches):
    """The partitioned service on a process group (NCCL, world size 1) at
    ``scale=1.0`` from phase 2's DiDiC maps: (a) cold sharded replays of
    filesystem's and Twitter's 10,000-op logs, bit-equal to the batched
    replays phase 2 holds, and of the first ``PHASE12_GIS_OPS`` ops of
    GIS's phase-6 log, whose per-op counters equal phase 6's and whose
    four counters equal a batched replay of the same ops, through
    ``frontier_gather`` (a main-path run, its launches counted);
    (b) on GIS the resident fold against the random map, bit-equal to a
    batched replay, then one structural slice through a mesh service: a
    partial redo, bit-equal to a cold batched replay of the grown graph;
    (c) degraded mode: shard 0 failed, the replay bit-equal and counted;
    (d) the halo-exchange DiDiC on Twitter, 20 iterations, against random
    and the single-device DiDiC, run twice (``parts`` and ``w`` bit-equal,
    its ``segment_sum`` launches counted), and a damaged map refined; (e) a
    device-scan ``least_traffic`` log at 5 % on filesystem equal to the
    host log; (f) two mesh-runtime slices on Twitter bit-equal to the
    meshless runtime."""
    import torch.distributed as dist

    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.core import metrics, partitioners
    from repro_torch.core.didic import DidicConfig, didic_partition
    from repro_torch.core.didic_distributed import (
        didic_partition_distributed,
        didic_refine_distributed,
    )
    from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
    from repro_torch.core.dynamism import generate_dynamism
    from repro_torch.core.framework import InsertPartitioner, PartitionedGraphService
    from repro_torch.core.traffic import OpLog, execute_ops, generate_ops
    from repro_torch.core.traffic_sharded import get_replayer, replay_sharded
    from repro_torch.launch.mesh import make_replay_mesh

    t_phase = time.perf_counter()
    _open_nccl_world1()
    try:
        mesh = make_replay_mesh(device=dev)
        check(dist.get_backend() == "nccl" and mesh.size == 1,
              f"phase 12: an NCCL group of {mesh.size} rank on {mesh.device}")
        out = {"phase": 12, "card": smi, "world_size": mesh.size, "backend": dist.get_backend()}
        logs = {}

        # (a) cold sharded replays against the held batched results.
        for name in ("filesystem", "twitter", "gis"):
            g, parts = held[name]["graph"], held[name]["parts"]
            if name == "gis":
                whole = generate_ops(g, n_ops=N_OPS_GIS_DYNAMIC, seed=0)
                ops = OpLog(whole.pattern, whole.starts[:PHASE12_GIS_OPS].copy(),
                            whole.ends[:PHASE12_GIS_OPS].copy(), whole.t_l, whole.t_pg)
            else:
                ops = generate_ops(g, n_ops=N_OPS, seed=0)
            logs[name] = ops
            n_ops = ops.n_ops
            t0 = time.perf_counter()
            res, counts = _counted(lambda: replay_sharded(g, ops, mesh, parts, 4), main_launches)
            cold_s = time.perf_counter() - t0
            if name == "gis":
                six = held[name]["phase6_result"]
                check(np.array_equal(res.per_op_total, six.per_op_total[:n_ops])
                      and np.array_equal(res.per_op_global, six.per_op_global[:n_ops]),
                      f"phase 12: gis sharded replay of phase 6's first {n_ops} ops: per-op counters "
                      f"== phase 6's batched replay")
                want = execute_ops(g, ops, parts, 4, engine="batched", device=mesh.device)
                what = "a batched replay of the same log"
            else:
                want, what = held[name]["result"], "the batched replay of phase 2"
            check(_exact(res, want), f"phase 12: {name} sharded replay ({n_ops} ops) == {what}, "
                                     f"all four counters")
            out[name] = {"n_ops": n_ops, "cold_s": cold_s, "ops_per_s": n_ops / cold_s,
                         "frontier_gather_launches": counts["frontier_gather"]}
            if name == "gis":
                check(counts["frontier_gather"] > 0, f"phase 12: the sharded GIS replay went through "
                                                     f"frontier_gather ({counts['frontier_gather']} launches)")

        # (b) GIS: the resident fold against a new map, then a structural slice.
        g, ops = held["gis"]["graph"], logs["gis"]
        rand = partitioners.random_partition(g.n_nodes, 4, seed=0)
        t0 = time.perf_counter()
        res, counts = _counted(lambda: replay_sharded(g, ops, mesh, rand, 4), main_launches)
        fold_s = time.perf_counter() - t0
        state = ops.__dict__["_resident_replay"][get_replayer(g, ops.pattern, mesh)]
        resident_bytes = state.state_bytes()
        check(_exact(res, execute_ops(g, ops, rand, 4, engine="batched", device=mesh.device)),
              f"phase 12: gis resident fold against the random map == a batched replay "
              f"({fold_s:.3f} s against {out['gis']['cold_s']:.3f} s cold)")
        svc = PartitionedGraphService(g, 4, mesh=mesh, maintenance="shared")
        svc.partition_with(held["gis"]["parts"])
        svc.run_ops(ops)  # the resident state of (a)
        log = InsertPartitioner("random", 4, seed=0).allocate(svc.parts, PHASE12_SLICE, insert_rate=0.3,
                                                             graph=svc.graph)
        svc.apply_dynamism(log)
        t0 = time.perf_counter()
        res, counts = _counted(lambda: svc.run_ops(ops), main_launches)
        redo_s = time.perf_counter() - t0
        redo = get_replayer(svc.graph, ops.pattern, mesh).last_redo_ops
        check(0 < redo < ops.n_ops, f"phase 12: gis structural slice (+{log.n_new_vertices} vertices, "
                                    f"{log.dirty_vertices().shape[0]} dirty) re-solved {redo} of "
                                    f"{ops.n_ops} ops")
        check(_exact(res, execute_ops(svc.graph, ops, svc.parts, 4, engine="batched",
                                      device=mesh.device)),
              "phase 12: gis partial redo == a cold batched replay of the grown graph")
        out["gis"].update({"resident_fold_s": fold_s, "resident_state_bytes": resident_bytes,
                           "structural_redo_ops": redo, "structural_replay_s": redo_s,
                           "structural_frontier_gather_launches": counts["frontier_gather"]})
        say(f"phase 12: gis resident fold {fold_s:.3f} s against cold {out['gis']['cold_s']:.3f} s "
            f"({resident_bytes} B resident); structural slice: {redo} ops re-solved in {redo_s:.3f} s")
        del svc, state

        # (c) degraded mode on filesystem.
        g, ops = held["filesystem"]["graph"], logs["filesystem"]
        svc = PartitionedGraphService(g, 4, mesh=mesh)
        svc.partition_with(held["filesystem"]["parts"])
        svc.mark_shard_failed(0)
        res = svc.run_ops(ops)
        health = svc.logger.health_report()
        check(_exact(res, held["filesystem"]["result"]) and health["degraded_replays"] == 1
              and health["degraded_ops"] == ops.n_ops,
              f"phase 12: filesystem with shard 0 failed: bit-equal, degraded_replays "
              f"{health['degraded_replays']}, degraded_ops {health['degraded_ops']} == {ops.n_ops}")
        svc.mark_shard_recovered(0)
        check(_exact(svc.run_ops(ops), held["filesystem"]["result"])
              and svc.logger.degraded_replays == 1,
              "phase 12: filesystem recovered: sharded again, bit-equal, no new degraded replay")
        out["degraded"] = health

        # (d) the halo-exchange DiDiC on Twitter, twice: parts and w bit-equal.
        g = held["twitter"]["graph"]
        cfg = DidicConfig(k=4, iterations=20, smooth_cap=64)
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ((p_mesh, _), states), counts = _counted(
                lambda: _keep_mesh_states(lambda: didic_partition_distributed(g, cfg, mesh, seed=0)), main_launches)
            torch.cuda.synchronize()
            runs.append((p_mesh, states[-1].w, time.perf_counter() - t0, counts))
        mesh_s = runs[0][2]
        check(np.array_equal(runs[0][0], runs[1][0]) and _bits_equal(runs[0][1], runs[1][1]),
              f"phase 12: twitter halo DiDiC, 20 iterations run twice: parts and w bit-equal "
              f"({runs[0][2]:.2f} s, {runs[1][2]:.2f} s)")
        check(runs[0][3]["segment_sum"] > 0, f"phase 12: the halo DiDiC summed through segment_sum "
                                             f"({runs[0][3]['segment_sum']} launches a run)")
        t0 = time.perf_counter()
        p_one, _ = didic_partition(g, cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        cut = {"mesh": metrics.edge_cut_fraction(g, p_mesh), "single": metrics.edge_cut_fraction(g, p_one),
               "random": metrics.edge_cut_fraction(g, partitioners.random_partition(g.n_nodes, 4, seed=0))}
        check(cut["mesh"] < cut["random"] and cut["mesh"] < max(2.5 * cut["single"], 0.1),
              f"phase 12: twitter halo DiDiC cut {cut['mesh']:.4f} < random {cut['random']:.4f} and "
              f"< max(2.5 x single-device {cut['single']:.4f}, 0.1)")
        check(min(np.bincount(p_mesh, minlength=4)) > 0, "phase 12: every halo DiDiC part non-empty")
        dmg = _damaged(p_mesh, 4, 0)
        fixed, _ = didic_refine_distributed(g, dmg, cfg, mesh, iterations=1)
        cut["damaged"] = metrics.edge_cut_fraction(g, dmg)
        cut["refined"] = metrics.edge_cut_fraction(g, fixed)
        check(cut["refined"] < cut["damaged"], f"phase 12: one halo refine iteration: cut "
                                               f"{cut['damaged']:.4f} -> {cut['refined']:.4f}")
        out["didic"] = {"cuts": cut, "mesh_s_per_iteration": mesh_s / cfg.iterations,
                        "single_s_per_iteration": one_s / cfg.iterations, "mesh_s": [r[2] for r in runs],
                        "segment_sum_launches": runs[0][3]["segment_sum"]}
        say(f"phase 12: twitter DiDiC 20 iterations: halo exchange {mesh_s:.2f} s, single device "
            f"{one_s:.2f} s")

        # (e) the device scan against the host loop.
        g, parts = held["filesystem"]["graph"], held["filesystem"]["parts"]
        vt = held["filesystem"]["result"].per_vertex
        kw = dict(k=4, vertex_traffic=vt, seed=0)
        t0 = time.perf_counter()
        host = generate_dynamism(parts, 0.05, "least_traffic", **kw)
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scan = generate_dynamism(parts, 0.05, "least_traffic", engine="device", device=dev, **kw)
        scan_s = time.perf_counter() - t0
        check(np.array_equal(host.vertices, scan.vertices) and np.array_equal(host.targets, scan.targets),
              f"phase 12: filesystem least_traffic at 5 % ({scan.units} units): device scan == host log")
        out["scan"] = {"units": scan.units, "host_s": host_s, "device_s": scan_s}

        # (f) two mesh-runtime slices on Twitter against the meshless runtime.
        g, ops = held["twitter"]["graph"], logs["twitter"]
        rt_config = PaperExperimentConfig(didic_iterations=DIDIC_ITERATIONS).didic("twitter", 4)
        got = {"host": [], "mesh": []}
        runs = {}
        for key, m in (("host", None), ("mesh", mesh)):
            svc = PartitionedGraphService(g, 4, rt_config, device=dev, mesh=m, maintenance="shared")
            svc.partition_with(held["twitter"]["parts"])
            rt = DynamicExperimentRuntime(svc, "least_traffic", seed=0)
            t0 = time.perf_counter()
            runs[key] = rt.run(ops, n_slices=2, amount=0.05, maintain_every=1,
                               on_slice=lambda i, r, key=key: got[key].append(r))
            torch.cuda.synchronize()
            out.setdefault("runtime_s", {})[key] = time.perf_counter() - t0
        check(_exact(runs["host"].baseline, runs["mesh"].baseline)
              and all(_exact(a, b) for a, b in zip(got["host"], got["mesh"])) and len(got["mesh"]) == 2
              and runs["host"].records == runs["mesh"].records,
              "phase 12: twitter mesh runtime (sharded replay, device scan, shared DiDiC), 2 slices "
              "== the meshless runtime on every counter")
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    say(json.dumps(out))
    say(f"phase 12: {out['phase_s']:.1f} s (budget {PHASE12_BUDGET_S:.0f} s"
        + (", over" if out["phase_s"] > PHASE12_BUDGET_S else "") + ")")


# ---------------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------------
PHASE13_BUDGET_S = 60.0
PHASE13_TOKENS = 4_096          # the EP forward's sequence, as phase 9's
PHASE13_CUT_AT_S = 1050.0       # past this on the script's clock, phase 13 cuts its own depth
PHASE13_CUT_GCN_STEPS = 20      # (c)'s steps after the cut ((a)'s ranks: the first and last layer)
EP_MODEL_RANKS = 4              # 13a: the model ranks one card plays in turn
EP_RANKS_ATOL_STEPS = 4         # their summed parts against moe_fwd: bf16 steps of the largest entry
GCN_STEPS = 60                  # the JAX example's steps
GCN_CPU_STEPS = 5               # the CPU run the card's first losses are held to
GCN_CPU_RTOL = 1e-4             # the card's matmuls sum in another order (its segment sums in the CPU's)


def _phase13_lm_config():
    """deepseek-moe-16b at ``FULL`` width and depth (28 layers, 64 routed
    experts top-6, 2 shared; bf16)."""
    from repro_torch.configs.deepseek_moe_16b import FULL

    return FULL


class _ModelRankView:
    """Model rank ``q`` of a ``(1, model)`` mesh, played on this one card:
    the shape and axis index such a rank sees, so ``shard_tree`` gives it
    its shards and the model code its part. The data axis has one rank, so
    a collective over it is the identity. Each collective along the model
    axis is recorded in ``calls`` (kind, op, the rank's tensor) and takes
    its result from ``known``, in call order: for an ``all_reduce`` the
    ranks' reduction, for an ``all_gather`` every rank's part (computed
    from the whole by the caller, or replayed by :func:`_play_model_ranks`),
    for a ``reduce_scatter`` the ranks' sum, of which it returns this
    rank's block. Past the known results an ``all_reduce`` keeps the rank's
    part in ``parts`` and passes it on (the caller sums the ranks' parts, as
    the ``all_reduce`` would), an ``all_gather`` puts the rank's own part in
    every place and a ``reduce_scatter`` returns the rank's own block."""

    def __init__(self, q, model, known=()):
        self.q, self.shape, self.parts = q, {"data": 1, "model": model}, []
        self.known, self.calls = list(known), []

    def axis_index(self, axes):
        return self.q if "model" in ((axes,) if isinstance(axes, str) else tuple(axes)) else 0

    def _meet(self, kind, t, op, axis):
        """The known result of this model-axis call (None: not known yet);
        ``False`` for a call along the data axis alone."""
        if "model" not in ((axis,) if isinstance(axis, str) else tuple(axis or ("data", "model"))):
            return False
        i = len(self.calls)
        self.calls.append((kind, op, t.detach()))
        return self.known[i] if i < len(self.known) else None

    def all_reduce(self, t, op=None, axis=None):
        r = self._meet("all_reduce", t, op, axis)
        if r is None:
            # detached: a part holding its autograd graph would close a cycle
            # through a node that keeps this view, which no collector frees
            self.parts.append(t.detach())
        return t if r is None or r is False else r.clone()

    def all_gather(self, t, axis=None):
        r = self._meet("all_gather", t, None, axis)
        if r is False:
            return [t]
        return [t] * self.shape["model"] if r is None else [p.clone() for p in r]

    def reduce_scatter(self, t, axis=None):
        r = self._meet("reduce_scatter", t, None, axis)
        if r is False:
            return t
        return (t if r is None else r).chunk(self.shape["model"], dim=0)[self.q].clone()


def _play_model_ranks(model, fn):
    """``fn(view)`` for each of ``model`` ranks in turn, replayed until every
    model-axis collective's result is known: each pass runs every rank to
    its end, then the first collective whose result was not known gets it
    from the ranks' parts (summed in rank order in their type, as a ring
    adds them, or their maximum, or the list of them). Returns the last
    pass's outputs (each rank's, with every collective as the mesh would
    give it) and the number of passes."""
    import functools

    import torch.distributed as dist

    known = []
    while True:
        views = [_ModelRankView(q, model, known) for q in range(model)]
        outs = [fn(v) for v in views]
        i = len(known)
        if len(views[0].calls) == i:
            return outs, i + 1
        kind, op, _ = views[0].calls[i]
        parts = [v.calls[i][2] for v in views]
        if kind == "all_gather":
            known.append(parts)
        else:
            known.append(functools.reduce(torch.maximum if op == dist.ReduceOp.MAX else torch.add, parts))
        del views, outs


def _phase13_ep_ranks(cfg, params, dev, layers):
    """Each of ``layers``' MoE as ``EP_MODEL_RANKS`` model ranks compute it,
    one after another on this card: rank q holds experts ``[16q, 16q + 16)``
    and its quarter of the shared expert's columns (placed by ``shard_tree``
    with ``lm_param_specs``), routes all 4,096 tokens, drops the assignments
    to other ranks' experts and runs its experts and its shared-expert
    partial; the ranks' parts summed against ``moe_fwd`` on the whole layer.
    Inputs: seeded unit normals, as the RMS-normed hidden state. Returns the
    largest gap over the layers, the largest entry it is relative to and
    whether every aux was the dense one bit for bit."""
    from repro_torch.distributed.sharding import lm_param_specs, shard_tree
    from repro_torch.models import transformer as tf
    from repro_torch.models.moe import moe_fwd, moe_fwd_ep

    gen = torch.Generator(device=dev).manual_seed(1)
    worst, scale, aux_equal, close = 0.0, 0.0, True, True
    for i in layers:
        lp = tf.layer_params(params, i)["moe"]
        x = torch.randn((1, PHASE13_TOKENS, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
        want, want_aux = moe_fwd(lp, x, cfg.moe)
        parts = []
        for q in range(EP_MODEL_RANKS):
            view = _ModelRankView(q, EP_MODEL_RANKS)
            mine = shard_tree({"moe": lp}, lm_param_specs({"layers": {"moe": lp}})["layers"], view)["moe"]
            _, aux = moe_fwd_ep(mine, x, cfg.moe, view)
            aux_equal = aux_equal and torch.equal(aux, want_aux)
            parts += view.parts
            del mine
        y = parts[0]
        for part in parts[1:]:
            y = y + part
        y = y.reshape(want.shape)
        gap, top = float((y.float() - want.float()).abs().max()), float(want.float().abs().max())
        close = close and gap <= EP_RANKS_ATOL_STEPS * 2.0 ** -7 * top
        worst, scale = max(worst, gap), max(scale, top)
    return close, worst, scale, aux_equal


def _phase13_moe_ep(mesh, dev, main_launches, cut):
    """(a) The forward of deepseek-moe-16b on the (1, 1) mesh (attention
    tensor parallel, the MoE expert parallel), its parameters placed by
    ``shard_tree`` with ``lm_param_specs``, against the dense forward on the
    same parameters: bit-equal logits and aux. The mesh forward is the
    main-path run (28 ``flash_attention`` launches). Then each layer's MoE
    split over four model ranks (:func:`_phase13_ep_ranks`; past the cut,
    the first and the last layer)."""
    from repro_torch import kernels
    from repro_torch.data.pipeline import LmDataConfig, lm_token_stream
    from repro_torch.distributed.sharding import lm_batch_spec, lm_param_specs, shard_tree
    from repro_torch.models import transformer as tf

    cfg = _phase13_lm_config()
    params, init_s = once(lambda: tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    placed = shard_tree(params, lm_param_specs(params), mesh)
    check(all(a is b for a, b in zip(_leaves(params), _leaves(placed))),
          f"phase 13: {cfg.name} placed by shard_tree on the (1, 1) mesh: every leaf is the "
          f"drawn one (no copy)")
    batch = next(lm_token_stream(LmDataConfig(vocab=cfg.vocab, seq_len=PHASE13_TOKENS, batch=1, seed=0)))
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    local = shard_tree({"t": tokens}, {"t": lm_batch_spec(mesh)}, mesh)["t"]
    with torch.no_grad():
        dense, dense_aux = tf.forward(cfg, params, tokens)
        torch.cuda.reset_peak_memory_stats()
        ((logits, aux), fwd_s), counts = _counted(
            lambda: once(lambda: tf.forward(cfg, placed, local, mesh=mesh)), main_launches)
        peak = torch.cuda.max_memory_allocated()
        routes = dict(kernels.KERNELS["flash_attention"].route_launches)
        check(torch.equal(logits, dense) and torch.equal(aux, dense_aux),
              f"phase 13: {cfg.name} EP forward over {PHASE13_TOKENS} tokens == the dense forward, "
              f"bit for bit (logits and aux {float(aux):.6f})")
        check(counts["flash_attention"] == cfg.n_layers and routes == {"wgmma": cfg.n_layers},
              f"phase 13: the EP forward launched flash_attention {counts['flash_attention']} times, "
              f"one a layer, all on wgmma ({routes})")
        del logits, dense
        _, fwd2_s = once(lambda: tf.forward(cfg, placed, local, mesh=mesh))
        layers = (0, cfg.n_layers - 1) if cut else range(cfg.n_layers)
        (ranks, ranks_s) = once(lambda: _phase13_ep_ranks(cfg, params, dev, layers))
    close, gap, top, aux_equal = ranks
    check(close and aux_equal,
          f"phase 13: {len(layers)} layers' MoE on {EP_MODEL_RANKS} model ranks (each its "
          f"{cfg.moe.n_experts // EP_MODEL_RANKS} experts and a quarter of the shared expert, the others' "
          f"assignments dropped), the parts "
          f"summed == moe_fwd within {EP_RANKS_ATOL_STEPS} bfloat16 steps of the largest entry "
          f"(largest gap {gap:.4g} of {top:.4g}); every rank's aux == the dense aux, bit for bit")
    rec = {"model": cfg.name, "layers": cfg.n_layers, "tokens": PHASE13_TOKENS, "init_s": init_s,
           "forward_first_s": fwd_s, "forward_s": fwd2_s, "tokens_per_s": PHASE13_TOKENS / fwd2_s,
           "peak_device_bytes": peak, "flash_attention_launches": counts["flash_attention"],
           "ep_ranks": {"model_ranks": EP_MODEL_RANKS, "layers": len(layers), "max_abs_gap": gap,
                        "max_abs_dense": top, "seconds": ranks_s}}
    say(f"phase 13: {cfg.name} EP forward {fwd2_s:.4f} s ({PHASE13_TOKENS / fwd2_s:.0f} tokens/s), "
        f"peak {peak / 1e9:.2f} GB; {EP_MODEL_RANKS} model ranks {ranks_s:.2f} s")
    return rec


def _phase13_online(held, dev, main_launches):
    """(b) The online server on GIS at ``scale=1.0`` on a mesh service
    (``maintenance="shared"``) from phase 2's DiDiC map: a clean leg and a
    leg with an admit crash, a commit crash and shard 0 failed for 4 ticks,
    each equal to the offline replay of its epochs and to the other leg,
    and no resident state after serving."""
    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.launch.mesh import make_replay_mesh

    g, parts = held["gis"]["graph"], held["gis"]["parts"]
    mesh = make_replay_mesh(device=dev)
    config = PaperExperimentConfig(didic_iterations=DIDIC_ITERATIONS).didic("gis", 4)
    legs, rec = {}, {}
    for leg, plan in (("clean", None), ("crash", _online_plan().fail_shard(1, shard=0, slices=4))):
        svc = PartitionedGraphService(g, 4, config, device=dev, mesh=mesh, maintenance="shared")
        svc.partition_with(parts.copy())
        res, seconds, off, n, n_off = _online_leg(svc, g, GIS_CLASSES, "uniform", plan, dev, main_launches)
        legs[leg] = res
        resident = svc._resident_state_bytes()
        rec[leg] = {"ops": res.ops_served, "seconds": seconds, "ops_per_s": res.ops_served / seconds,
                    "ticks": res.ticks, "batches": res.batches_served, "epochs": len(res.epochs),
                    "latency": res.latency, "health": res.health, "resident_state_bytes": resident,
                    "frontier_gather_launches": n, "offline_frontier_gather_launches": n_off}
        check(res.ops_served == ONLINE_REQUESTS and _served_equal(_served(res), off),
              f"phase 13: gis online on the mesh, {leg}: {res.ops_served} ops over {res.ticks} ticks and "
              f"{len(res.epochs)} epochs, equal to the offline replay of its epochs")
        check(resident == 0 and res.health["resident_state_bytes"] == 0,
              f"phase 13: gis online {leg}: no resident replay state after serving")
        check(n > 0, f"phase 13: gis online {leg}: the replays went through frontier_gather ({n} launches)")
    clean, crash = legs["clean"], legs["crash"]
    check(crash.health["recoveries"] == 2 and crash.health["degraded_replays"] > 0
          and _served_equal(_served(crash), _served(clean)) and crash.latency == clean.latency,
          f"phase 13: the crash leg (2 recoveries, {crash.health['degraded_replays']} degraded replays) "
          f"equals the clean leg on every counter and the latency report")
    return rec


def _phase13_gcn(held, mesh, dev, steps, main_launches):
    """(c) The distributed GCN twin at world size 1 on GIS at ``scale=1.0``,
    phase 2's DiDiC map folded onto the one shard, ``steps`` steps (a
    main-path run through ``segment_sum``), then run again, every loss
    bit-equal; the halo bytes of the random and DiDiC placements at 4
    shards (host numbers). Returns the record and the initial parameters
    (drawn on the CPU)."""
    from repro_torch import distributed_gnn_training as twin
    from repro_torch.core import partitioners
    from repro_torch.models import gnn

    g, parts = held["gis"]["graph"], held["gis"]["parts"]
    table = twin.halo_table(g, {"random": partitioners.random_partition(g.n_nodes, 4, seed=0),
                                "didic": parts})
    check(table["didic"][0] < table["random"][0],
          f"phase 13: GIS halo bytes a step at 4 shards: DiDiC {table['didic'][0]:.0f} < random "
          f"{table['random'][0]:.0f} (edge cut {table['didic'][1]:.4f} against {table['random'][1]:.4f})")
    params0 = gnn.gcn_init(twin.CFG, torch.Generator().manual_seed(0), device="cpu")
    torch.cuda.reset_peak_memory_stats()
    run, counts = _counted(lambda: twin.train(g, parts, mesh, steps=steps,
                                              params={k: v.to(dev) for k, v in params0.items()}), main_launches)
    peak = torch.cuda.max_memory_allocated()
    losses = run.losses
    check(len(losses) == steps and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"phase 13: distributed GCN on GIS ({g.n_nodes:,} nodes, {run.layout.n_shards} shard), "
          f"{steps} steps: losses finite, {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(counts["segment_sum"] > 0, f"phase 13: the GCN's halo product summed through segment_sum "
                                     f"({counts['segment_sum']} launches)")
    again = twin.train(g, parts, mesh, steps=steps, params={k: v.to(dev) for k, v in params0.items()})
    check(again.losses == losses, f"phase 13: the distributed GCN run again: all {steps} losses bit-equal")
    rec = {"nodes": g.n_nodes, "shards": run.layout.n_shards, "steps": steps,
           "halo_bytes_4_shards": {k: v[0] for k, v in table.items()},
           "edge_cut_4_shards": {k: v[1] for k, v in table.items()},
           "losses": losses, "train_s": run.seconds, "step_ms": run.seconds / steps * 1e3,
           "again_step_ms": again.seconds / steps * 1e3, "evals": run.evals, "peak_device_bytes": peak,
           "launches": counts}
    say(f"phase 13: distributed GCN {rec['step_ms']:.2f} ms a step, peak {peak / 1e9:.3f} GB")
    return rec, params0


def phase13(held, dev, smi, main_launches, t_start):
    """The model side of multi-device on an NCCL group of one rank, a
    ``("data", "model")`` mesh of (1, 1): (a) deepseek-moe-16b's forward on
    the mesh against its dense forward; (b) the online server on a GIS mesh
    service; (c) the distributed GCN twin on GIS, then its first losses
    against the same run on the CPU (a gloo group of one rank). Past
    ``PHASE13_CUT_AT_S`` on the script's clock it cuts its own depth."""
    import torch.distributed as dist

    from repro_torch import distributed_gnn_training as twin
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    cut = t_phase - t_start > PHASE13_CUT_AT_S
    _open_nccl_world1()
    try:
        mesh = make_host_mesh(device=dev)
        check(dist.get_backend() == "nccl" and mesh.shape == {"data": 1, "model": 1},
              f"phase 13: an NCCL group of {mesh.size} rank, mesh {mesh.shape} on {mesh.device}")
        out = {"phase": 13, "card": smi, "mesh": mesh.shape, "cut": cut}
        t0 = time.perf_counter()
        out["moe_ep"] = _phase13_moe_ep(mesh, dev, main_launches, cut)
        torch.cuda.empty_cache()
        out["moe_ep"]["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["online"] = _phase13_online(held, dev, main_launches)
        out["online_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["gcn"], params0 = _phase13_gcn(held, mesh, dev, PHASE13_CUT_GCN_STEPS if cut else GCN_STEPS,
                                           main_launches)
        out["gcn"]["part_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        cpu = twin.train(held["gis"]["graph"], held["gis"]["parts"], make_host_mesh(device="cpu"),
                         steps=GCN_CPU_STEPS, params=params0).losses
    finally:
        dist.destroy_process_group()
    card = out["gcn"]["losses"][:GCN_CPU_STEPS]
    gap = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    out["gcn"].update({"cpu_losses": cpu, "cpu_rel_gap": gap, "cpu_s": time.perf_counter() - t0})
    check(gap <= GCN_CPU_RTOL, f"phase 13: the GCN's first {GCN_CPU_STEPS} losses on the card == the CPU's "
                               f"within {GCN_CPU_RTOL} (largest relative gap {gap:.2e})")
    out["phase_s"] = time.perf_counter() - t_phase
    say(json.dumps(out))
    say(f"phase 13: {out['phase_s']:.1f} s (budget {PHASE13_BUDGET_S:.0f} s"
        + (", over" if out["phase_s"] > PHASE13_BUDGET_S else "") + (", cut" if cut else "") + ")")


# ---------------------------------------------------------------------------
# phase 14
# ---------------------------------------------------------------------------
PHASE14_BUDGET_S = 40.0
PHASE14_CUT_AT_S = 1050.0     # past this on the script's clock, (c) cuts its slices
PHASE14_SLICE = 0.0005        # a growth slice: 0.05 % of the vertices as units
PHASE14_GIS_OPS = 128         # (c)'s GIS log: the first ops of phase 6's (one chunk)
PHASE14_GIS_SLICES = (4, 2)   # (c)'s growth slices, and after the cut


def _geometry(store) -> dict:
    return {"n_cap": store.n_cap, "e_cap": store.e_cap, "base_nodes": store.base_nodes,
            "base_edges": store.base_edges, "compactions": store.compactions,
            "headroom": store.headroom}


def _phase14_boundaries(held, dev, main_launches):
    """(a) Filesystem at ``scale=1.0``: a store filled exactly by one growth
    log is carried; the next log compacts. Each grown graph's replay (a
    main-path run) equals a fresh storeless engine's and the scalar oracle
    on 64 ops."""
    from repro_torch.core.framework import InsertPartitioner, PartitionedGraphService
    from repro_torch.core.traffic import generate_ops
    from repro_torch.core.traffic_batched import BatchedTrafficEngine

    g = _bare(held["filesystem"]["graph"])
    ops = generate_ops(g, n_ops=N_OPS, seed=0)
    svc = PartitionedGraphService(g, 4, device=dev).partition_with(held["filesystem"]["parts"].copy())
    ip = InsertPartitioner("random", 4, seed=0)
    log = ip.allocate(svc.parts, PHASE14_SLICE, insert_rate=0.5, graph=g)
    nv, ne = log.n_new_vertices, int(log.insert_senders.shape[0])
    store = g.ensure_store(n_cap=g.n_nodes + nv, e_cap=g.n_edges + ne)
    svc.apply_dynamism(log)
    check(svc.graph.store is store and store.compactions == 0 and store.delta_nodes(svc.graph) == nv
          and store.delta_edges(svc.graph) == ne and not store.would_overflow(svc.graph, 0, 0)
          and store.would_overflow(svc.graph, 1, 0),
          f"phase 14 (a): filesystem +{nv} vertices, +{ne} edges fill the store exactly; carried, "
          f"no compaction")
    out = {"exactly_full": _geometry(store)}
    for what in ("store exactly full", "after the compaction"):
        res, _ = _counted(lambda: svc.run_ops(ops), main_launches)
        fresh = BatchedTrafficEngine(_bare(svc.graph), ops.pattern, device=dev).run(
            ops, svc.parts, 4, ops.t_l, ops.t_pg)
        check(_exact(res, fresh), f"phase 14 (a): filesystem, {what}: the store's engine == a fresh "
                                  f"storeless engine, {ops.n_ops} ops, all four counters")
        _oracle_check(svc.graph, ops, svc.parts, dev, f"phase 14 (a): filesystem, {what}")
        if what == "store exactly full":
            log = ip.allocate(svc.parts, PHASE14_SLICE, insert_rate=0.5, graph=svc.graph)
            svc.apply_dynamism(log)
            new = svc.graph.store
            check(new is not store and new.compactions == store.compactions + 1 == 1
                  and new.delta_nodes(svc.graph) == log.n_new_vertices
                  and new.delta_edges(svc.graph) == int(log.insert_senders.shape[0]),
                  f"phase 14 (a): one more growth log (+{log.n_new_vertices} vertices) compacts: a "
                  f"new store (n_cap {new.n_cap}), its delta exactly that log")
            out["compacted"] = _geometry(new)
    return out


def _phase14_compact_crash(held, dev, main_launches):
    """(b) A crash at ``apply:compact`` on Twitter at ``scale=1.0``: a
    3-slice growth run (random inserts, maintenance at the third slice)
    with a store of tiny headroom, so slice 0 compacts; recovered
    (snapshots every 2 slices) bit-exact against the uninterrupted run."""
    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
    from repro_torch.core.fault import FaultPlan, RetryPolicy
    from repro_torch.core.framework import PartitionedGraphService
    from repro_torch.core.recovery import DynamismJournal, run_with_recovery
    from repro_torch.core.traffic import generate_ops

    base = _bare(held["twitter"]["graph"])
    parts = held["twitter"]["parts"]
    config = PaperExperimentConfig(didic_iterations=DIDIC_ITERATIONS).didic("twitter", 4)
    ops = generate_ops(base, n_ops=N_OPS, seed=0)
    kw = dict(maintain_every=3, insert_rate=0.5)

    def make():
        base.ensure_store(n_cap=base.n_nodes + 4, e_cap=base.n_edges + 16)
        svc = PartitionedGraphService(base, 4, config, device=dev).partition_with(parts.copy())
        return DynamicExperimentRuntime(svc, "random", seed=0)

    want, got, peaks = {}, {}, []
    torch.cuda.reset_peak_memory_stats()
    ref_rt = make()
    (ref, ref_s), _ = _counted(lambda: once(lambda: ref_rt.run(
        ops, 3, PHASE14_SLICE, on_slice=lambda i, r: want.__setitem__(i, r), **kw)), main_launches)
    peaks.append(torch.cuda.max_memory_allocated())
    compactions = ref_rt.service.graph.store.compactions
    del ref_rt
    torch.cuda.reset_peak_memory_stats()
    ((out, stats), rec_s), _ = _counted(lambda: once(lambda: run_with_recovery(
        make, base, ops, 3, PHASE14_SLICE, fault_plan=FaultPlan().crash(0, site="apply:compact"),
        journal=DynamismJournal(), retry_policy=RetryPolicy(), snapshot_every=2,
        on_slice=lambda i, r: got.__setitem__(i, r), **kw)), main_launches)
    peaks.append(torch.cuda.max_memory_allocated())
    check(compactions >= 1 and stats.recoveries == 1 and stats.journal_rolled_back >= 1
          and stats.resumed_from == [0],
          f"phase 14 (b): the uninterrupted run compacted ({compactions}); the crash at apply:compact "
          f"recovered once, its pending entry rolled back")
    check(all(_exact(want[i], got[i]) for i in range(3)) and ref.records == out.records
          and np.array_equal(ref.parts, out.parts),
          "phase 14 (b): recovered run == uninterrupted run, all four counters on each of 3 slices, "
          "records and final map")
    return {"uninterrupted_s": ref_s, "recovered_s": rec_s, "compactions": compactions,
            "restore_s": stats.restore_s, "peak_device_bytes": peaks}


def _phase14_gis(held, dev, main_launches, n_slices):
    """(c) GIS at ``scale=1.0``: growth slices within capacity on a service
    armed by ``prepare_growth``. The engine is one object whose capacity
    buffers are never reallocated, each replay (a main-path run) launches
    ``frontier_gather``, the peak stays flat, and each adoption is timed
    beside a fresh engine's build on the same grown graph (neither with the
    grown graph's symmetrization, timed apart, nor with the whole-graph
    layout, which an adoption drops and a full pass builds again); the
    last slice's replay equals the fresh engine's. Then the overlay DiDiC
    step on the grown graph, twice: bit-identical."""
    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.core.didic import didic_refine
    from repro_torch.core.framework import InsertPartitioner, PartitionedGraphService
    from repro_torch.core.traffic import OpLog, generate_ops
    from repro_torch.core.traffic_batched import BatchedTrafficEngine, get_engine

    g = _bare(held["gis"]["graph"])
    whole = generate_ops(g, n_ops=N_OPS_GIS_DYNAMIC, seed=0)
    ops = OpLog(whole.pattern, whole.starts[:PHASE14_GIS_OPS].copy(),
                whole.ends[:PHASE14_GIS_OPS].copy(), whole.t_l, whole.t_pg)
    svc = PartitionedGraphService(g, 4, device=dev).partition_with(held["gis"]["parts"].copy())
    prep = once(svc.prepare_growth)[1]
    eng = get_engine(g, ops.pattern, device=dev)
    buffers = [t.data_ptr() for t in (eng._lon_buf, eng._lat_buf, eng._rank_buf)]
    ip = InsertPartitioner("random", 4, seed=0)
    out = {"prepare_s": prep, "symmetrize_s": [], "adopt_s": [], "rebuild_s": [],
           "peak_device_bytes": [], "resident_bytes": [], "frontier_gather_launches": []}
    for i in range(n_slices):
        log = ip.allocate(svc.parts, PHASE14_SLICE, insert_rate=0.5, graph=svc.graph)
        svc.apply_dynamism(log)
        # The grown graph's symmetrized edge list is host work an adoption
        # and a rebuild both need (DiDiC's tables too): built once, apart.
        out["symmetrize_s"].append(once(lambda: svc.graph.undirected)[1])
        torch.cuda.reset_peak_memory_stats()
        same, adopt_s = once(lambda: get_engine(svc.graph, ops.pattern, device=dev))
        out["resident_bytes"].append(torch.cuda.memory_allocated())
        res, counts = _counted(lambda: svc.run_ops(ops), main_launches)
        out["peak_device_bytes"].append(torch.cuda.max_memory_allocated())
        out["adopt_s"].append(adopt_s)
        out["frontier_gather_launches"].append(counts["frontier_gather"])
        check(same is eng and eng.n_nodes == svc.graph.n_nodes and counts["frontier_gather"] > 0
              and [t.data_ptr() for t in (eng._lon_buf, eng._lat_buf, eng._rank_buf)] == buffers,
              f"phase 14 (c): gis growth slice {i} (+{log.n_new_vertices} vertices): the same engine "
              f"adopted it in {adopt_s:.3f} s into the buffers it holds; the replay launched "
              f"frontier_gather {counts['frontier_gather']} times")
        bare = _bare(svc.graph)
        bare.__dict__["undirected"] = svc.graph.undirected
        fresh, rebuild_s = once(lambda: BatchedTrafficEngine(bare, ops.pattern, device=dev))
        out["rebuild_s"].append(rebuild_s)
        if i == n_slices - 1:
            check(_exact(res, fresh.run(ops, svc.parts, 4, ops.t_l, ops.t_pg)),
                  f"phase 14 (c): gis after {n_slices} growth slices: the adopted engine's replay == a "
                  f"fresh engine's, all four counters")
        del fresh, bare
    store = svc.graph.store
    peaks, held_b = out["peak_device_bytes"], out["resident_bytes"]
    check(store.compactions == 0 and max(peaks[1:], default=peaks[0]) <= 1.1 * peaks[0]
          and max(held_b[1:], default=held_b[0]) <= 1.01 * held_b[0],
          f"phase 14 (c): gis {n_slices} slices within capacity (n_cap {store.n_cap}), peak per slice "
          f"{peaks} B, flat within 10 % of slice 0's; held after each adoption {held_b} B, within 1 %")
    out["store"] = _geometry(store)
    # The overlay DiDiC step on the grown graph: capacity-shaped state, dead
    # rows exactly 0, and two runs equal bit for bit (no float atomics).
    config = PaperExperimentConfig(didic_iterations=DIDIC_ITERATIONS).didic("gis", 4)
    runs = [once(lambda: didic_refine(svc.graph, svc.parts, config, device=dev)) for _ in range(2)]
    (p1, s1), (p2, s2) = runs[0][0], runs[1][0]
    n = svc.graph.n_nodes
    check(s1.w.shape[0] == store.n_cap + 1 and not s1.w[n:].any() and not s1.l[n:].any()
          and np.array_equal(p1, p2) and all(torch.equal(getattr(s1, f), getattr(s2, f))
                                             for f in ("w", "l", "parts", "beta")),
          f"phase 14 (c): gis overlay refine on the grown graph: {s1.w.shape[0]} state rows, dead "
          f"rows 0, two runs bit-identical ({runs[0][1]:.3f} s with the tables' build, "
          f"{runs[1][1]:.3f} s)")
    out["overlay_refine_s"] = [runs[0][1], runs[1][1]]
    return out


def _phase14_mesh(held, dev, smi):
    """(d) On an NCCL group of one rank: a Twitter mesh service with
    ``maintenance="sharded"`` refines (one iteration, cold from phase 2's
    DiDiC map) before and after one growth slice within capacity through
    one ``_CapacityMeshProgram``; each map's T_G % (a sharded replay) lies
    in ``0.25·ref + 0.01`` of the single-device overlay refine's from the
    same map."""
    import torch.distributed as dist

    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.core.didic import didic_refine
    from repro_torch.core.framework import InsertPartitioner, PartitionedGraphService
    from repro_torch.core.traffic import execute_ops, generate_ops
    from repro_torch.launch.mesh import make_replay_mesh

    g = _bare(held["twitter"]["graph"])
    config = PaperExperimentConfig(didic_iterations=DIDIC_ITERATIONS).didic("twitter", 4)
    ops = generate_ops(g, n_ops=N_OPS, seed=0)
    out = {}
    _open_nccl_world1()
    try:
        mesh = make_replay_mesh(device=dev)
        check(dist.get_backend() == "nccl" and mesh.size == 1,
              f"phase 14 (d): an NCCL group of {mesh.size} rank on {mesh.device}")
        svc = PartitionedGraphService(g, 4, config, mesh=mesh, maintenance="sharded")
        svc.partition_with(held["twitter"]["parts"].copy())
        svc.prepare_growth()
        key = ("mesh_program", mesh, ("data",))
        prog = g.store.caches[key]
        ip = InsertPartitioner("random", 4, seed=0)
        for leg in ("before growth", "after growth"):
            if leg == "after growth":
                log = ip.allocate(svc.parts, PHASE14_SLICE, insert_rate=0.5, graph=svc.graph)
                svc.apply_dynamism(log)
            start = svc.parts.copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.maintain()
            torch.cuda.synchronize()
            mesh_s = time.perf_counter() - t0
            mesh_pg = _pg(svc.run_ops(ops))
            single, _ = didic_refine(svc.graph, start, config, device=dev)
            single_pg = _pg(execute_ops(svc.graph, ops, single, 4, engine="batched", device=dev))
            check(svc.graph.store.caches.get(key) is prog and prog.extents == (svc.graph.n_nodes,
                                                                              svc.graph.n_edges)
                  and abs(mesh_pg - single_pg) <= 0.25 * single_pg + 0.01,
                  f"phase 14 (d): twitter {leg}: sharded maintenance through the one capacity mesh "
                  f"program, T_G % {mesh_pg:.4f} in the band of the single-device overlay's "
                  f"{single_pg:.4f}")
            out[leg.replace(" ", "_")] = {"mesh_T_G_percent": mesh_pg, "single_T_G_percent": single_pg,
                                          "refine_s": mesh_s}
        out["store"] = _geometry(svc.graph.store)
    finally:
        dist.destroy_process_group()
    return out


def phase14(held, dev, smi, main_launches, t_start):
    """The capacity store on the card (module docstring, phase 14)."""
    t_phase = time.perf_counter()
    cut = t_phase - t_start > PHASE14_CUT_AT_S
    n_slices = PHASE14_GIS_SLICES[1] if cut else PHASE14_GIS_SLICES[0]
    out = {"phase": 14, "card": smi, "budget_s": PHASE14_BUDGET_S, "cut": cut}
    fg0 = main_launches.get("frontier_gather", 0)
    for part, fn in (("boundaries", lambda: _phase14_boundaries(held, dev, main_launches)),
                     ("compact_crash", lambda: _phase14_compact_crash(held, dev, main_launches)),
                     ("gis_growth", lambda: _phase14_gis(held, dev, main_launches, n_slices)),
                     ("mesh", lambda: _phase14_mesh(held, dev, smi))):
        t0 = time.perf_counter()
        out[part] = fn()
        out[part]["part_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["frontier_gather_launches"] = main_launches.get("frontier_gather", 0) - fg0
    out["phase_s"] = time.perf_counter() - t_phase
    say(json.dumps(out))
    gis = out["gis_growth"]
    say(f"phase 14: gis adoption per slice " + ", ".join(f"{t:.3f}" for t in gis["adopt_s"])
        + " s against a rebuild " + ", ".join(f"{t:.3f}" for t in gis["rebuild_s"])
        + " s (the grown graph's symmetrization apart: "
        + ", ".join(f"{t:.3f}" for t in gis["symmetrize_s"]) + f" s); frontier_gather {out['frontier_gather_launches']} launches; "
        f"{out['phase_s']:.1f} s (budget {PHASE14_BUDGET_S:.0f} s"
        + (", over" if out["phase_s"] > PHASE14_BUDGET_S else "") + (", cut" if cut else "") + ")")



# ---------------------------------------------------------------------------
# phase 15
# ---------------------------------------------------------------------------
PHASE15_BUDGET_S = 30.0
PHASE15_CUT_AT_S = 1050.0          # past this on the script's clock the depth is PHASE15_CUT_DEPTH, unprobed
PHASE15_TOKENS = 4096              # train_4k's sequence; its global batch of 256 cut to one sequence
PHASE15_STEPS = 3
PHASE15_DEPTHS = (6, 5, 4, 3, 2)   # the largest whose predicted step peak is within PHASE15_PEAK_LIMIT
PHASE15_PROBE_DEPTHS = (1, 2)
PHASE15_CUT_DEPTH = 2
PHASE15_PEAK_LIMIT = 70e9
PHASE15_MODEL_RANKS = 4            # (b): one layer's MoE backward as 4 model ranks, 32 experts each
PHASE15_ATOL_STEPS = 1             # (b)'s bar: bfloat16 steps (2^-7) of the dense gradient's largest entry
# x's gradient is bfloat16: each rank's partial is rounded once before the
# partials are summed, and the dense gradient once, so m + 1 roundings of at
# most half a step each stand between them (1.16 steps measured, run U1).
PHASE15_X_ATOL_STEPS = (PHASE15_MODEL_RANKS + 1) / 2
# AdamW as phase 10 trains: the registry step's default config warms up over
# 100 steps, and its first updates (lr 3e-6, 6e-6) are below the rounding of
# most bf16 weights, so the loss could not be seen to fall in 3 steps.
PHASE15_LR = TRAIN_LR


def _phase15_arch():
    """qwen3-moe-30b-a3b at ``FULL`` width (d_model 2,048, 32/4 heads, Dh
    128, 128 experts top-8 of d_ff 768, vocab 151,936, bf16), remat off: the
    step as this phase has always measured it (its depth probe, peak and one
    launch a layer a step); phase 17 runs remat."""
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL

    return dataclasses.replace(FULL, remat=False)


def _phase15_params(cfg, dev):
    from repro_torch.models import transformer as tf

    return tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def _phase15_opt():
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(lr=PHASE15_LR, warmup_steps=1, total_steps=PHASE15_STEPS)


def _phase15_run(step, cfg, batch, dev):
    """``PHASE15_STEPS`` steps of ``step`` from the seeded parameters (drawn
    here, so only the step's own state is alive): the final state, the
    last loss, the losses and each step's seconds (host clock ending in a
    synchronize)."""
    from repro_torch.optim import adamw

    params = _phase15_params(cfg, dev)
    state = (params, adamw.init(params))
    del params
    losses, seconds, loss = [], [], None
    for _ in range(PHASE15_STEPS):
        t0 = time.perf_counter()
        p, o, loss = step(state[0], state[1], batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        state = (p, o)
        del p, o
        losses.append(float(loss))
    return state, loss, losses, seconds


def _phase15_depth(cfg, batch, mesh, dev, cut):
    """The largest of ``PHASE15_DEPTHS`` whose step peak, on the line through
    one EP step's peak at each probe depth, is within the limit (phase 10's
    rule); past the cut ``PHASE15_CUT_DEPTH``, unprobed."""
    import gc

    from repro_torch.configs import base
    from repro_torch.optim import adamw

    if cut:
        return PHASE15_CUT_DEPTH, {}, {}
    peaks = {}
    for d in PHASE15_PROBE_DEPTHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = base.lm_dryrun(cfg, "train_4k", mesh, n_layers_override=d, opt_cfg=_phase15_opt()).step_fn
        params = _phase15_params(dataclasses.replace(cfg, n_layers=d), dev)
        opt = adamw.init(params)
        out = step(params, opt, batch)
        del params, opt, out
        torch.cuda.synchronize()
        peaks[d] = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    (d0, p0), (d1, p1) = sorted(peaks.items())
    per_layer = (p1 - p0) / (d1 - d0)
    predicted = {d: peaks.get(d, p1 + (d - d1) * per_layer) for d in PHASE15_DEPTHS}
    depth = next((d for d in PHASE15_DEPTHS if predicted[d] <= PHASE15_PEAK_LIMIT), None)
    say(f"phase 15: {cfg.name} training peak, measured: " + ", ".join(
        f"{d} layers {p / 1e9:.2f} GB" for d, p in sorted(peaks.items()))
        + f"; {per_layer / 1e9:.3f} GB a layer; predicted " + ", ".join(
        f"{d} layers {predicted[d] / 1e9:.2f} GB" for d in PHASE15_DEPTHS))
    check(depth is not None, f"phase 15: a depth of {PHASE15_DEPTHS} trains within "
                             f"{PHASE15_PEAK_LIMIT / 1e9:.0f} GB")
    return depth, peaks, predicted


def _phase15_ep_step(cfg, depth, batch, mesh, dev, main_launches):
    """(a) The registry's ``train_4k`` step (``lm_dryrun`` on the live mesh:
    expert parallel) against the dense step: step 1's loss and every
    gradient leaf, then ``PHASE15_STEPS`` steps each, the losses and the
    final parameters, all bit for bit. The EP steps are the main-path run
    (one ``flash_attention`` launch a layer a step, on ``wgmma``)."""
    import gc

    from repro_torch import kernels
    from repro_torch.configs import base
    from repro_torch.launch.dryrun import output_shapes
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    cut = dataclasses.replace(cfg, n_layers=depth)
    ep_step = base.lm_dryrun(cfg, "train_4k", mesh, n_layers_override=depth, opt_cfg=_phase15_opt()).step_fn
    params = _phase15_params(cut, dev)
    loss_ep, g_ep = base.value_and_grad(lambda p: tf.loss_fn(cut, p, batch, mesh=mesh), params, mesh)
    loss_d, g_d = base.value_and_grad(lambda p: tf.loss_fn(cut, p, batch), params)
    n_leaves = len(list(adamw.leaves(g_d)))
    same = torch.equal(loss_ep, loss_d) and all(
        torch.equal(a, b) for a, b in zip(adamw.leaves(g_ep), adamw.leaves(g_d)))
    finite = all(bool(torch.isfinite(g).all()) for g in adamw.leaves(g_ep))
    experts = [bool(x) for x in (g_ep["layers"]["moe"]["w_up"].float().abs().amax(dim=(1, 2, 3)) > 0).tolist()]
    del params, g_ep, g_d
    check(same and finite, f"phase 15: step 1 on the (1, 1) mesh: the EP loss ({float(loss_ep):.6f}) and all "
                           f"{n_leaves} gradient leaves == the dense step's, bit for bit, all finite")
    check(all(experts), f"phase 15: every layer's expert stack has a non-zero gradient ({experts})")
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    (state, loss, losses, seconds), counts = _counted(lambda: _phase15_run(ep_step, cut, batch, dev),
                                                      main_launches)
    peak = torch.cuda.max_memory_allocated()
    routes = dict(kernels.KERNELS["flash_attention"].route_launches)
    bwd_routes = dict(kernels.KERNELS["flash_attention_bwd"].route_launches)
    shapes = output_shapes((state[0], state[1], loss))
    t0 = time.perf_counter()
    ep_final = [t.cpu() for t in adamw.leaves(state[0])]
    copy_s = time.perf_counter() - t0
    del state, loss
    gc.collect()
    torch.cuda.empty_cache()
    dense_state, _, dense_losses, dense_seconds = _phase15_run(base.lm_train_step(cut, None, _phase15_opt()), cut,
                                                               batch, dev)
    equal = all(torch.equal(a, b.cpu()) for a, b in zip(ep_final, adamw.leaves(dense_state[0])))
    del dense_state, ep_final
    gc.collect()
    torch.cuda.empty_cache()
    n = PHASE15_STEPS * depth
    check(losses == dense_losses and equal,
          f"phase 15: {PHASE15_STEPS} EP steps == {PHASE15_STEPS} dense steps, bit for bit: losses "
          f"({', '.join(f'{x:.6f}' for x in losses)}) and every parameter after step {PHASE15_STEPS}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"phase 15: the loss falls, {losses[0]:.6f} -> {losses[-1]:.6f}")
    check(counts["flash_attention"] == n and routes == {"wgmma": n},
          f"phase 15: the EP steps launched flash_attention {counts['flash_attention']} times, one a layer "
          f"a step, all on wgmma ({routes})")
    check(counts["flash_attention_bwd"] == n and bwd_routes == {"wgmma": n},
          f"phase 15: the EP steps launched flash_attention_bwd {counts['flash_attention_bwd']} times, one a layer "
          f"a step, all on wgmma ({bwd_routes})")
    check(peak <= PHASE15_PEAK_LIMIT, f"phase 15: the EP run's peak {peak / 1e9:.2f} GB at {depth} layers "
                                      f"(<= {PHASE15_PEAK_LIMIT / 1e9:.0f} GB)")
    median_s = statistics.median(seconds)
    say(f"phase 15: {cut.name} {depth} layers EP, {PHASE15_STEPS} steps of {PHASE15_TOKENS} tokens: step s "
        f"{', '.join(f'{x:.4f}' for x in seconds)} (dense {', '.join(f'{x:.4f}' for x in dense_seconds)}); "
        f"median {median_s:.4f} s, {PHASE15_TOKENS / median_s:.0f} tokens/s; peak {peak:,} B")
    return {"depth": depth, "parameters": cut.param_count(), "losses": losses, "step_s": seconds,
            "dense_step_s": dense_seconds, "median_step_s": median_s, "tokens_per_s": PHASE15_TOKENS / median_s,
            "peak_device_bytes": peak, "flash_attention_launches": counts["flash_attention"],
            "flash_attention_routes": routes, "flash_attention_bwd_launches": counts["flash_attention_bwd"],
            "host_copy_s": copy_s}, shapes


def _phase15_ep_ranks(cfg, dev):
    """(b) One layer's MoE backward as ``PHASE15_MODEL_RANKS`` model ranks
    played in turn (``_ModelRankView``): rank q holds experts ``[32q, 32q +
    32)``, routes all 4,096 tokens and backpropagates ``sum(y_q · w)``
    through its own part ``y_q`` (the view's model-axis reduce is the
    identity, so each rank's router and x gradients are its partial ones).
    Each rank's expert gradients against the matching slice of the dense
    gradient; the partial router and x gradients summed once against the
    dense ones. The loss leaves the aux out: it is the same on every rank
    (its gradient counted once is held on the CPU, 4 gloo ranks)."""
    from repro_torch.distributed.sharding import lm_param_specs, shard_tree
    from repro_torch.models.moe import moe_fwd, moe_fwd_ep, moe_init
    from repro_torch.optim.adamw import leaves, tree_map

    gen = torch.Generator(device=dev).manual_seed(2)
    lp = moe_init(gen, cfg.d_model, cfg.moe, cfg.dtype, dev)
    x = torch.randn((1, PHASE15_TOKENS, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    w = torch.randn((1, PHASE15_TOKENS, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    names = ["x", *sorted(lp)]

    def grads(fn, p):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        xl = x.detach().requires_grad_(True)
        y, _ = fn(live, xl)
        return dict(zip(names, torch.autograd.grad((y.float() * w.float()).sum(), [xl, *leaves(live)])))

    dense = grads(lambda p, xx: moe_fwd(p, xx, cfg.moe), lp)
    e_loc = cfg.moe.n_experts // PHASE15_MODEL_RANKS
    summed = {"x": torch.zeros_like(dense["x"], dtype=torch.float32),
              "router": torch.zeros_like(dense["router"])}
    expert_gap = {k: 0.0 for k in ("w_gate", "w_up", "w_down")}
    for q in range(PHASE15_MODEL_RANKS):
        view = _ModelRankView(q, PHASE15_MODEL_RANKS)
        mine = shard_tree({"moe": lp}, lm_param_specs({"layers": {"moe": lp}})["layers"], view)["moe"]
        g = grads(lambda p, xx: moe_fwd_ep(p, xx, cfg.moe, view), mine)
        for k in expert_gap:
            want = dense[k][q * e_loc:(q + 1) * e_loc]
            expert_gap[k] = max(expert_gap[k], float((g[k].float() - want.float()).abs().max()))
        summed["x"] += g["x"].float()
        summed["router"] += g["router"]
        del mine, g
    top = {k: float(dense[k].float().abs().max()) for k in names}
    gaps = dict(expert_gap, x=float((summed["x"] - dense["x"].float()).abs().max()),
                router=float((summed["router"] - dense["router"]).abs().max()))
    steps = {k: PHASE15_X_ATOL_STEPS if k == "x" else PHASE15_ATOL_STEPS for k in names}
    check(all(gaps[k] <= steps[k] * 2.0 ** -7 * top[k] for k in names) and all(top[k] > 0 for k in names),
          f"phase 15: one layer's MoE backward on {PHASE15_MODEL_RANKS} model ranks ({e_loc} experts each): "
          f"each rank's expert gradients == the dense slice and the partial router gradients summed once == the "
          f"dense one within {PHASE15_ATOL_STEPS} bfloat16 step of the largest entry, the partial x gradients "
          f"within {PHASE15_X_ATOL_STEPS} (" + ", ".join(
              f"{k} {gaps[k]:.3g} of {top[k]:.3g}, {gaps[k] / (2.0 ** -7 * top[k]):.2f} steps" for k in names) + ")")
    return {"model_ranks": PHASE15_MODEL_RANKS, "max_abs_gap": gaps, "max_abs_dense": top,
            "bf16_steps": {k: gaps[k] / (2.0 ** -7 * top[k]) for k in names}}


def _phase15_meta(cfg, depth, card_shapes, seconds):
    """(c) The same cell built on ``meta`` by the registry (a (1, 1)
    ``MetaMesh``, the card's batch of one sequence): its output shapes
    against the card's, and the step's FLOPs as counted there."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import base
    from repro_torch.launch.dryrun import output_shapes
    from repro_torch.launch.mesh import MetaMesh

    meta_mesh = MetaMesh({"data": 1, "model": 1})
    spec = base.lm_dryrun(cfg, "train_4k", meta_mesh, n_layers_override=depth)
    params, opt, _ = base.rank_args(spec, meta_mesh)
    batch = {k: torch.empty((1, PHASE15_TOKENS), dtype=torch.int32, device="meta") for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as counter:
        out = spec.step_fn(params, opt, batch)
    meta_s = time.perf_counter() - t0
    shapes = output_shapes(out)
    flops = float(counter.get_total_flops())
    check(shapes == card_shapes, f"phase 15: the registry's cell on meta gives the card's {len(shapes)} output "
                                 f"shapes and dtypes ({meta_s:.2f} s, nothing allocated)")
    median_s = statistics.median(seconds)
    say(f"phase 15: {flops / 1e12:.2f} TFLOP a step counted on meta; {flops / median_s / 1e12:.1f} TFLOP/s "
        f"on the card ({flops / median_s / PEAK_BF16_FLOPS * 100:.1f} % of the bf16 peak)")
    return {"output_leaves": len(shapes), "flops_per_step": flops, "tflops_per_s": flops / median_s / 1e12,
            "meta_s": meta_s}


def phase15(dev, smi, main_launches, t_start):
    """qwen3-moe-30b-a3b's ``train_4k`` step from the config registry, expert
    parallel on an NCCL group of one rank, a (1, 1) ``HostMesh`` (module
    docstring, phase 15)."""
    import gc

    import torch.distributed as dist

    from repro_torch.data.pipeline import LmDataConfig, lm_token_stream
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    cut = t_phase - t_start > PHASE15_CUT_AT_S
    cfg = _phase15_arch()
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    check(resident < PHASE9_RESIDENT_LIMIT,
          f"phase 15: {resident:,} bytes allocated on the card before {cfg.name} is drawn (< 2 GB)")
    raw = next(lm_token_stream(LmDataConfig(vocab=cfg.vocab, seq_len=PHASE15_TOKENS, batch=1)))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    out = {"phase": 15, "card": smi, "budget_s": PHASE15_BUDGET_S, "cut": cut, "model": cfg.name,
           "tokens": PHASE15_TOKENS}
    _open_nccl_world1()
    try:
        mesh = make_host_mesh(device=dev)
        check(dist.get_backend() == "nccl" and mesh.shape == {"data": 1, "model": 1},
              f"phase 15: an NCCL group of {mesh.size} rank, mesh {mesh.shape} on {mesh.device}")
        t0 = time.perf_counter()
        depth, probes, predicted = _phase15_depth(cfg, batch, mesh, dev, cut)
        out["probe_peak_device_bytes"], out["predicted_peak_device_bytes"] = probes, predicted
        out["probe_s"] = time.perf_counter() - t0
        say(f"phase 15: {cfg.name} trained at full width (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
            f"heads, Dh {cfg.head_dim}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff {cfg.moe.d_ff}, "
            f"vocab {cfg.vocab}, {cfg.dtype}); cut: depth {cfg.n_layers} -> {depth} layers (AdamW's float32 "
            f"moments and a pure step do not fit 48 layers on one card), the global batch of 256 sequences "
            f"-> 1 of {PHASE15_TOKENS} tokens, repeated each step; AdamW at lr {PHASE15_LR} without warm-up "
            f"(the default warm-up's first updates round away in bf16)"
            + (" (past the cut: depth unprobed)" if cut else ""))
        t0 = time.perf_counter()
        out["ep_step"], card_shapes = _phase15_ep_step(cfg, depth, batch, mesh, dev, main_launches)
        out["ep_step"]["part_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    out["ep_ranks"] = _phase15_ep_ranks(cfg, dev)
    out["ep_ranks"]["part_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    out["meta"] = _phase15_meta(cfg, depth, card_shapes, out["ep_step"]["step_s"])
    out["phase_s"] = time.perf_counter() - t_phase
    say(json.dumps(out))
    say(f"phase 15: {out['phase_s']:.1f} s (budget {PHASE15_BUDGET_S:.0f} s"
        + (", over" if out["phase_s"] > PHASE15_BUDGET_S else "") + (", cut" if cut else "") + ")")


# ---------------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------------
PHASE16_BUDGET_S = 10.0
PHASE16_CUT_AT_S = 1100.0   # past this on the script's clock (b) runs PHASE16_CUT_SLICES slices
PHASE16_SLICES = 20         # the sentinel's default schedule: 20 slices of 5 %
PHASE16_CUT_SLICES = 5


def phase16(dev, smi, t_start):
    """repro-lint over the port and its growth sentinel on the card (module
    docstring, phase 16)."""
    import torch.distributed as dist

    import repro_torch.analysis as lint
    from repro_torch.analysis import recompile

    t_phase = time.perf_counter()
    cut = t_phase - t_start > PHASE16_CUT_AT_S
    slices = PHASE16_CUT_SLICES if cut else PHASE16_SLICES
    out = {"phase": 16, "card": smi, "budget_s": PHASE16_BUDGET_S, "cut": cut}

    t0 = time.perf_counter()
    files = lint.iter_source_files(pathlib.Path(ROOT))
    findings = lint.run_lint(pathlib.Path(ROOT))
    baseline = lint.load_baseline(pathlib.Path(ROOT, "src", "repro_torch", "analysis", "baseline.json"))
    new, suppressed, _stale = lint.split_by_baseline(findings, baseline)
    out["lint"] = {"files": len(files), "rules": len(lint.RULES), "findings": len(findings),
                   "new": [f.format() for f in new], "baseline_suppressed": len(suppressed),
                   "part_s": time.perf_counter() - t0}
    check(not new, f"phase 16 (a): repro-lint over {len(files)} files of src/repro_torch, "
          f"{len(lint.RULES)} rules: {len(new)} new findings against the baseline "
          f"({len(suppressed)} baselined)")

    t0 = time.perf_counter()
    _open_nccl_world1()
    try:
        check(dist.get_backend() == "nccl", "phase 16 (b): the sentinel on an NCCL group of one rank")
        report = recompile.run_growth_sentinel(slices=slices, device=dev)
    finally:
        dist.destroy_process_group()
    per = report["per_slice"]
    sentinel_findings = recompile.findings_from_report(report, pathlib.Path(ROOT))
    out["sentinel"] = {k: report[k] for k in ("schedule", "service_device", "tensor_devices", "warmup_seconds",
                                              "compactions", "total_rebuilds_after_warmup", "total_refreshes",
                                              "steady_state", "retraces")}
    out["sentinel"].update(per_slice=per, warmup_builds=[e["name"] for e in report["warmup_builds"]],
                           part_s=time.perf_counter() - t0)
    check(report["service_device"].startswith("cuda") and report["tensor_devices"]
          and all(d.startswith("cuda") for d in report["tensor_devices"]),
          f"phase 16 (b): the service on {report['service_device']}, its engine's and replayer's "
          f"tensors on {report['tensor_devices']}")
    check(per[-1]["n_nodes"] > per[0]["n_nodes"],
          f"phase 16 (b): the graph grew over {slices} slices ({per[0]['n_nodes']} -> {per[-1]['n_nodes']} vertices)")
    check(per[0]["rebuilds"] > 0, f"phase 16 (b): slice 0 built {per[0]['rebuilds']} objects "
          f"(warm-up: {', '.join(out['sentinel']['warmup_builds'])})")
    check(report["total_rebuilds_after_warmup"] == 0 and report["steady_state"] and not sentinel_findings,
          f"phase 16 (b): {report['total_rebuilds_after_warmup']} rebuilds after warm-up, steady state "
          f"{report['steady_state']}, {len(sentinel_findings)} findings")
    out["phase_s"] = time.perf_counter() - t_phase
    say(json.dumps(out))
    say("phase 16: sentinel seconds a slice " + ", ".join(f"{s['seconds']:.3f}" for s in per)
        + "; refreshes a slice " + ", ".join(str(s["refreshes"]) for s in per)
        + f"; lint {out['lint']['part_s']:.2f} s, sentinel {out['sentinel']['part_s']:.2f} s; "
        f"{out['phase_s']:.1f} s (budget {PHASE16_BUDGET_S:.0f} s"
        + (", over" if out["phase_s"] > PHASE16_BUDGET_S else "") + (", cut" if cut else "") + ")")


# ---------------------------------------------------------------------------
# phase 17
# ---------------------------------------------------------------------------
PHASE17_BUDGET_S = 30.0
PHASE17_CUT_AT_S = 1050.0   # past this on the script's clock (a) trains PHASE17_CUT_LAYERS layers
PHASE17_TOKENS = 4_096      # one sequence, as phases 10, 13 and 15
PHASE17_LAYERS = 2          # (a)'s depth
PHASE17_CUT_LAYERS = 1
PHASE17_LAYER_RANKS = 4     # (b): granite's layer as 4 model ranks (8 q heads, 2 kv heads, 3,200 FFN columns)
PHASE17_HEAD_RANKS = 16     # (c): yi-34b's attention, 3.5 q heads a rank
PHASE17_DECODE_RANKS = 16   # (d): granite's decode, 2,048 cache positions a rank
PHASE17_DECODE_BATCH = 8    # decode_32k's 128 sequences over 16 data shards
PHASE17_DECODE_LEN = 32_768
# The bars, in bfloat16 steps (2^-7) of the dense result's largest entry,
# stated before the first card run. A sum over m model ranks rounds each
# rank's part once and the dense result once: (m + 1) / 2 half-steps at most
# for (c) and (d); (b) chains attention into the FFN and backpropagates
# through both, so its forward and every gradient get 4 steps, as 13a's
# summed parts do; the loss one step of itself (the logits are bfloat16).
PHASE17_LAYER_ATOL_STEPS = 4
PHASE17_HEAD_ATOL_STEPS = (PHASE17_HEAD_RANKS + 1) / 2
PHASE17_DECODE_ATOL_STEPS = (PHASE17_DECODE_RANKS + 1) / 2
PHASE17_LOSS_RTOL_STEPS = 1


def _bf16_steps(got, want) -> tuple:
    """``(gap in bf16 steps of want's largest entry, gap, largest entry)``."""
    gap, top = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    return gap / (2.0 ** -7 * top), gap, top


def _granite_tp_cfg(n_layers):
    """granite-3-8b at ``FULL`` width (remat on, as the JAX config), the vocab
    padded to a multiple of 128 as the registry's cells pad it (49,280: 12,320
    rows a rank at 4), ``n_layers`` deep."""
    from repro_torch.configs.granite_3_8b import FULL

    return dataclasses.replace(FULL, vocab=-(-FULL.vocab // 128) * 128, n_layers=n_layers)


def _phase17_train(mesh, depth, batch, dev, main_launches):
    """(a) granite-3-8b's ``train_4k`` step from the registry on the (1, 1)
    mesh (the JAX layout: tensor-parallel attention and SwiGLU,
    vocabulary-parallel embedding and cross-entropy, remat) at ``depth``
    layers against the dense step: the loss, every gradient and the updated
    parameters bit for bit; the gradients also bit-equal to the step without
    remat. The mesh step is the main-path run: one ``flash_attention``
    launch a layer in the forward and one in remat's recompute."""
    import gc

    from repro_torch import kernels
    from repro_torch.configs import base
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    cfg = _granite_tp_cfg(depth)
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=1)
    params, init_s = once(lambda: tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    loss_tp, g_tp = base.value_and_grad(lambda p: tf.loss_fn(cfg, p, batch, mesh=mesh), params, mesh)
    loss_d, g_d = base.value_and_grad(lambda p: tf.loss_fn(cfg, p, batch), params)
    plain = dataclasses.replace(cfg, remat=False)
    loss_n, g_n = base.value_and_grad(lambda p: tf.loss_fn(plain, p, batch), params)
    n_leaves = len(list(adamw.leaves(g_d)))
    same = torch.equal(loss_tp, loss_d) and all(torch.equal(a, b) for a, b in zip(adamw.leaves(g_tp), adamw.leaves(g_d)))
    remat_same = torch.equal(loss_n, loss_d) and all(
        torch.equal(a, b) for a, b in zip(adamw.leaves(g_n), adamw.leaves(g_d)))
    finite = all(bool(torch.isfinite(g).all()) for g in adamw.leaves(g_tp))
    attn_live = all(bool(g_tp["layers"]["attn"][w].float().abs().amax(dim=(1, 2)).min() > 0) for w in ("wq", "wk", "wv"))
    del g_tp, g_d, g_n
    gc.collect()
    check(same and finite and attn_live,
          f"phase 17 (a): {cfg.name} {depth} layers on the (1, 1) mesh, tensor parallel: the loss "
          f"({float(loss_tp):.6f}) and all {n_leaves} gradient leaves == the dense step's, bit for bit, all finite, "
          f"wq/wk/wv non-zero in every layer")
    check(remat_same, "phase 17 (a): remat's loss and gradients == the step without remat, bit for bit")

    state = adamw.init(params)
    step = base.lm_dryrun(cfg, "train_4k", mesh, n_layers_override=depth, opt_cfg=opt).step_fn
    torch.cuda.reset_peak_memory_stats()
    ((new_tp, _, loss), step_s), counts = _counted(lambda: once(lambda: step(params, state, batch)), main_launches)
    peak = torch.cuda.max_memory_allocated()
    routes = dict(kernels.KERNELS["flash_attention"].route_launches)
    bwd_routes = dict(kernels.KERNELS["flash_attention_bwd"].route_launches)
    new_d, _, loss0 = base.lm_train_step(cfg, None, opt)(params, state, batch)
    equal = torch.equal(loss, loss0) and all(torch.equal(a, b) for a, b in zip(adamw.leaves(new_tp),
                                                                                 adamw.leaves(new_d)))
    moved = not torch.equal(new_tp["layers"]["attn"]["wq"], params["layers"]["attn"]["wq"])
    del new_tp, new_d, params, state
    gc.collect()
    torch.cuda.empty_cache()
    check(equal and moved, f"phase 17 (a): the registry's train_4k step on the mesh == the dense step, bit for bit "
                           f"(loss {float(loss):.6f}, every parameter after the AdamW update; wq moved)")
    check(counts["flash_attention"] == 2 * depth and routes == {"wgmma": 2 * depth},
          f"phase 17 (a): the step launched flash_attention {counts['flash_attention']} times, one a layer in the "
          f"forward and one in remat's recompute, all on wgmma ({routes})")
    check(counts["flash_attention_bwd"] == depth and bwd_routes == {"wgmma": depth},
          f"phase 17 (a): the step launched flash_attention_bwd {counts['flash_attention_bwd']} times, one a layer "
          f"in the backward, all on wgmma ({bwd_routes})")
    say(f"phase 17 (a): {cfg.name} {depth} layers, one {PHASE17_TOKENS}-token sequence: TP step {step_s:.4f} s "
        f"(the first, no warm-up), peak {peak:,} B; parameters drawn in {init_s:.2f} s")
    return {"layers": depth, "loss": float(loss), "step_s": step_s, "peak_device_bytes": peak,
            "flash_attention_launches": counts["flash_attention"], "flash_attention_routes": routes,
            "flash_attention_bwd_launches": counts["flash_attention_bwd"]}


def _rank_params(params, view):
    """Model rank ``view.q``'s shards of ``params`` (a tree with the LM's
    names) in the JAX layout."""
    from repro_torch.distributed.sharding import lm_param_specs, shard_tree

    return shard_tree(params, lm_param_specs(params), view)


def _phase17_layer(dev):
    """(b) One granite-3-8b layer at full width as ``PHASE17_LAYER_RANKS``
    model ranks in turn (:func:`_play_model_ranks`: every collective as the
    mesh would give it), its output and the gradient of ``sum(y · w)`` in x
    and in each rank's shards against the dense layer; then the
    vocabulary-parallel embedding (bit-equal) and cross-entropy (the mean
    loss) against the dense ones on a seeded hidden state."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import leaves, tree_map

    cfg = _granite_tp_cfg(1)
    m = PHASE17_LAYER_RANKS
    gen = torch.Generator(device=dev).manual_seed(3)
    params = tf.init_params(cfg, gen, device=dev)
    lp = tf.layer_params(params, 0)
    x = torch.randn((1, PHASE17_TOKENS, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    w = torch.randn((1, PHASE17_TOKENS, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    names = ["x"] + [".".join(k) for k in _paths(lp)]

    def run(p, mesh):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        xl = x.detach().requires_grad_(True)
        y, _ = tf._layer_fwd(cfg, live, xl, mesh)
        return y.detach(), dict(zip(names, torch.autograd.grad((y.float() * w.float()).sum(), [xl, *leaves(live)])))

    t0 = time.perf_counter()
    y_d, g_d = run(lp, None)
    dense_s = time.perf_counter() - t0
    mine = [tf.layer_params(_rank_params({"layers": params["layers"]}, _ModelRankView(q, m)), 0) for q in range(m)]
    t0 = time.perf_counter()
    outs, passes = _play_model_ranks(m, lambda v: run(mine[v.q], v))
    ranks_s = time.perf_counter() - t0
    # each rank's shard against its slice of the dense gradient (columns: dim
    # 1, rows: dim 0); x and the norms' scales whole on every rank
    split = {"attn.wq": 1, "attn.wk": 1, "attn.wv": 1, "attn.wo": 0, "ffn.w_gate": 1, "ffn.w_up": 1,
             "ffn.w_down": 0}
    steps = {"y": _bf16_steps(outs[0][0], y_d)}
    for k in names:
        want = [g_d[k].chunk(m, dim=split[k])[q] if k in split else g_d[k] for q in range(m)]
        gap = max(float((outs[q][1][k].float() - want[q].float()).abs().max()) for q in range(m))
        top = float(g_d[k].float().abs().max())
        steps[k] = (gap / (2.0 ** -7 * top), gap, top)
    same_y = all(torch.equal(o[0], outs[0][0]) for o in outs)
    del outs, g_d, mine
    check(same_y and all(st[0] <= PHASE17_LAYER_ATOL_STEPS for st in steps.values()),
          f"phase 17 (b): one {cfg.name} layer as {m} model ranks in turn ({cfg.n_heads // m} q heads, "
          f"{cfg.n_kv_heads // m} kv heads, {cfg.d_ff // m} FFN columns a rank; {passes} replay passes): the output "
          f"(the same on every rank) and the gradients in x and every shard within {PHASE17_LAYER_ATOL_STEPS} bf16 "
          f"steps of the dense layer's largest entry (" + ", ".join(f"{k} {st[0]:.2f}" for k, st in steps.items())
          + ")")

    tokens = torch.randint(0, cfg.vocab, (1, PHASE17_TOKENS), generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab, (1, PHASE17_TOKENS), generator=gen, device=dev)
    ends = {k: params[k] for k in ("embed", "ln_f", "lm_head")}
    heads = [_rank_params(ends, _ModelRankView(q, m)) for q in range(m)]
    with torch.no_grad():
        emb_d = tf.embed_tokens(params, tokens)
        loss_d = float(tf.token_nll(tf.head(params, x), labels).mean())
        outs, loss_passes = _play_model_ranks(m, lambda v: (
            tf.embed_tokens(heads[v.q], tokens, v), tf.token_nll(tf.head(heads[v.q], x, v), labels, v).mean()))
    loss_tp = float(outs[0][1])
    emb_equal = all(torch.equal(o[0], emb_d) for o in outs)
    rows = params["embed"].shape[0] // m
    del outs, params, heads
    check(emb_equal, f"phase 17 (b): the vocabulary-parallel embedding ({rows:,} rows a rank) == the dense lookup, "
                     f"bit for bit")
    check(abs(loss_tp - loss_d) <= PHASE17_LOSS_RTOL_STEPS * 2.0 ** -7 * abs(loss_d),
          f"phase 17 (b): the vocabulary-parallel cross-entropy over {m} ranks ({loss_passes} replay passes) "
          f"{loss_tp:.6f} == the dense {loss_d:.6f} within {PHASE17_LOSS_RTOL_STEPS} bf16 step "
          f"(gap {abs(loss_tp - loss_d):.3g})")
    say(f"phase 17 (b): dense layer forward+backward {dense_s:.3f} s; {m} ranks x {passes} passes {ranks_s:.3f} s")
    return {"model_ranks": m, "passes": passes, "bf16_steps": {k: st[0] for k, st in steps.items()},
            "max_abs_gap": {k: st[1] for k, st in steps.items()}, "loss": loss_tp, "dense_loss": loss_d,
            "dense_s": dense_s, "ranks_s": ranks_s}


def _paths(tree, prefix=()):
    """The key paths of a nested dict's leaves, in ``adamw.leaves`` order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,)


def _phase17_heads(dev, main_launches):
    """(c) yi-34b's attention at full width as ``PHASE17_HEAD_RANKS`` model
    ranks in turn: each rank's ``wo`` rows are 3.5 heads, so q is gathered
    with k and v (every rank's part computed from the whole products), the
    rank runs ``flash_attention`` once on the 4 heads its rows touch, and
    the ranks' row-parallel parts, summed, against the dense attention.
    The ranks' launches are a main-path run."""
    from repro_torch import kernels
    from repro_torch.configs.yi_34b import FULL as cfg
    from repro_torch.models import layers as L

    m = PHASE17_HEAD_RANKS
    gen = torch.Generator(device=dev).manual_seed(4)
    lp = L.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype, dev)
    x = torch.randn((1, PHASE17_TOKENS, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    with torch.no_grad():
        want = L.attention_fwd(lp, x, cfg.n_heads, cfg.n_kv_heads)
        known = [list((x @ lp[k]).chunk(m, dim=-1)) for k in ("wq", "wk", "wv")]
        torch.cuda.reset_peak_memory_stats()

        def ranks():
            parts = []
            for q in range(m):
                view = _ModelRankView(q, m, known)
                mine = _rank_params({"layers": {"attn": lp}}, view)["layers"]["attn"]
                L.attention_fwd(mine, x, cfg.n_heads, cfg.n_kv_heads, mesh=view)
                parts += view.parts
            return parts

        (parts, ranks_s), counts = _counted(lambda: once(ranks), main_launches)
        peak = torch.cuda.max_memory_allocated()
        routes = dict(kernels.KERNELS["flash_attention"].route_launches)
        got = parts[0]
        for part in parts[1:]:
            got = got + part
    st = _bf16_steps(got, want)
    check(len(parts) == m and st[0] <= PHASE17_HEAD_ATOL_STEPS,
          f"phase 17 (c): {cfg.name}'s attention as {m} model ranks in turn (3.5 q heads of wo rows a rank, q "
          f"gathered), the parts summed == the dense attention within {PHASE17_HEAD_ATOL_STEPS} bf16 steps of its "
          f"largest entry ({st[0]:.2f} steps: gap {st[1]:.4g} of {st[2]:.4g})")
    check(counts["flash_attention"] == m and routes == {"wgmma": m},
          f"phase 17 (c): {counts['flash_attention']} flash_attention launches, one a rank, all on wgmma ({routes})")
    say(f"phase 17 (c): {m} ranks {ranks_s:.3f} s, peak {peak:,} B")
    return {"model_ranks": m, "bf16_steps": st[0], "max_abs_gap": st[1], "max_abs_dense": st[2],
            "ranks_s": ranks_s, "peak_device_bytes": peak, "flash_attention_launches": counts["flash_attention"]}


def _phase17_decode(dev):
    """(d) granite-3-8b's decode attention against a full 32,768-position
    cache (8 sequences, the new token at the last position), split-K as
    ``PHASE17_DECODE_RANKS`` model ranks in turn (2,048 positions each;
    q, k and v gathered, the partial softmaxes combined by log-sum-exp,
    replayed by :func:`_play_model_ranks`) against the dense
    ``decode_attention``; the owner of the position writes its row."""
    from repro_torch.configs.granite_3_8b import FULL as cfg
    from repro_torch.models import layers as L

    m, t, pos = PHASE17_DECODE_RANKS, PHASE17_DECODE_LEN, PHASE17_DECODE_LEN - 1
    gen = torch.Generator(device=dev).manual_seed(5)
    lp = L.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype, dev)
    x = torch.randn((PHASE17_DECODE_BATCH, 1, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    shape = (PHASE17_DECODE_BATCH, t, cfg.n_kv_heads, cfg.head_dim)
    ck = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    cv = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    tl = t // m
    with torch.no_grad():
        dk, dv = ck.clone(), cv.clone()
        t0 = time.perf_counter()
        want, _ = L.decode_attention(lp, x, cfg.n_heads, cfg.n_kv_heads, (dk, dv), pos)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0

        def rank(view):
            mine = _rank_params({"layers": {"attn": lp}}, view)["layers"]["attn"]
            sl = slice(view.q * tl, (view.q + 1) * tl)
            cache = (ck[:, sl].clone(), cv[:, sl].clone())
            out, _ = L.decode_attention(mine, x, cfg.n_heads, cfg.n_kv_heads, cache, pos, mesh=view)
            return out, cache

        t0 = time.perf_counter()
        outs, passes = _play_model_ranks(m, rank)
        torch.cuda.synchronize()
        ranks_s = time.perf_counter() - t0
    st = _bf16_steps(outs[0][0], want)
    owner = pos // tl
    written = all(torch.equal(outs[q][1][0], ck[:, q * tl:(q + 1) * tl]) for q in range(m) if q != owner)
    row = max(_bf16_steps(outs[owner][1][i][:, pos - owner * tl], d[:, pos])[0] for i, d in enumerate((dk, dv)))
    same = all(torch.equal(o[0], outs[0][0]) for o in outs)
    check(same and st[0] <= PHASE17_DECODE_ATOL_STEPS,
          f"phase 17 (d): {cfg.name}'s decode attention over {t:,} cached positions as {m} model ranks in turn "
          f"({tl:,} positions each, {passes} replay passes), split-K and combined by log-sum-exp == the dense "
          f"decode_attention within {PHASE17_DECODE_ATOL_STEPS} bf16 steps of its largest entry ({st[0]:.2f} steps: "
          f"gap {st[1]:.4g} of {st[2]:.4g}), the same on every rank")
    check(written and row <= 1, f"phase 17 (d): only rank {owner} wrote the new key and value, within one bf16 "
                                f"step of the dense cache's row ({row:.2f} steps); the other ranks' slices unchanged")
    say(f"phase 17 (d): dense decode {dense_s * 1e3:.3f} ms; {m} ranks x {passes} passes {ranks_s:.3f} s")
    return {"model_ranks": m, "passes": passes, "bf16_steps": st[0], "max_abs_gap": st[1], "max_abs_dense": st[2],
            "dense_ms": dense_s * 1e3, "ranks_s": ranks_s}


def phase17(dev, smi, main_launches, t_start):
    """The JAX layout's tensor-parallel LM on the card (module docstring,
    phase 17)."""
    import gc

    import torch.distributed as dist

    from repro_torch.data.pipeline import LmDataConfig, lm_token_stream
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    cut = t_phase - t_start > PHASE17_CUT_AT_S
    depth = PHASE17_CUT_LAYERS if cut else PHASE17_LAYERS
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    check(resident < PHASE9_RESIDENT_LIMIT,
          f"phase 17: {resident:,} bytes allocated on the card before granite-3-8b is drawn (< 2 GB)")
    cfg = _granite_tp_cfg(depth)
    raw = next(lm_token_stream(LmDataConfig(vocab=cfg.vocab, seq_len=PHASE17_TOKENS, batch=1)))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    out = {"phase": 17, "card": smi, "budget_s": PHASE17_BUDGET_S, "cut": cut}
    t0 = time.perf_counter()
    _open_nccl_world1()
    try:
        mesh = make_host_mesh(device=dev)
        check(dist.get_backend() == "nccl" and mesh.shape == {"data": 1, "model": 1},
              f"phase 17: an NCCL group of {mesh.size} rank, mesh {mesh.shape} on {mesh.device}")
        out["train"] = _phase17_train(mesh, depth, batch, dev, main_launches)
    finally:
        dist.destroy_process_group()
    out["train"]["part_s"] = time.perf_counter() - t0
    for key, fn in (("layer", lambda: _phase17_layer(dev)), ("heads", lambda: _phase17_heads(dev, main_launches)),
                    ("decode", lambda: _phase17_decode(dev))):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["part_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    say(json.dumps(out))
    say(f"phase 17: (a) {out['train']['part_s']:.1f} s, (b) {out['layer']['part_s']:.1f} s, (c) "
        f"{out['heads']['part_s']:.1f} s, (d) {out['decode']['part_s']:.1f} s; {out['phase_s']:.1f} s (budget "
        f"{PHASE17_BUDGET_S:.0f} s" + (", over" if out["phase_s"] > PHASE17_BUDGET_S else "")
        + (", cut" if cut else "") + ")")



# ---------------------------------------------------------------------------
# phase 18
# ---------------------------------------------------------------------------
PHASE18_BUDGET_S = 30.0
PHASE18_CUT_AT_S = 1050.0       # past this on the script's clock, phase 18 runs Twitter only
PHASE18_DATASETS = ("twitter", "gis")
PHASE18_BAND = (0.25, 0.01)     # |mesh - meshless| <= 0.25 ref + 0.01 (fractions): another DiDiC's sums


def _phase18_bench(names, held, dev):
    """The paper bench at ``scale=1.0`` with phase 2's graphs (host arrays),
    DiDiC maps and diffusion states and phase 6's logs in its caches, so it
    loads no graph and runs no initial DiDiC. Returns it and whether each
    log, map and DiDiC config is shown to be the one phase 6 measured."""
    from repro_torch import convert
    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.paper_tables import PaperBench

    cfg = PaperExperimentConfig(scale=1.0, n_ops=N_OPS, n_ops_gis=N_OPS_GIS_DYNAMIC, datasets=names)
    bench = PaperBench(cfg, device=dev)
    same = {}
    for name in names:
        h, six = held[name], held[name]["phase6"]
        bench._graphs[name] = h["graph"]
        bench._ops[name] = six["ops"]
        bench._parts[(name, "didic", 4)] = h["parts"].copy()
        bench._parts[(name, "didic_state", 4)] = convert.didic_state_from_arrays(*h["state"], device=dev)
        n_ops = cfg.n_ops_gis if name == "gis" else cfg.n_ops
        same[name] = (bench.ops(name) is six["ops"] and six["ops"].n_ops == n_ops
                      and np.array_equal(bench.partition(name, "didic", 4), six["parts"])
                      and cfg.didic(name, 4) == six["config"])
    return bench, same


def _phase18_table(bench, name, fn, main_launches):
    """One table on one dataset, a main-path run: its rows, seconds and
    launch counts."""
    bench.cfg = dataclasses.replace(bench.cfg, datasets=(name,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, counts = _counted(fn, main_launches)
    return {r.name: r for r in rows}, time.perf_counter() - t0, counts


def phase18(held, dev, smi, main_launches, t_start):
    """The paper's Stress and Dynamic tables on a mesh (module docstring,
    phase 18)."""
    import torch.distributed as dist

    from repro_torch.configs.paper_didic import PaperExperimentConfig
    from repro_torch.launch.mesh import make_replay_mesh
    from repro_torch.paper_tables import PaperBench, row_names

    t_phase = time.perf_counter()
    cut = t_phase - t_start > PHASE18_CUT_AT_S
    names = ("twitter",) if cut else PHASE18_DATASETS
    say(f"phase 18: the paper's Stress and Dynamic tables on a mesh, {', '.join(names)} at scale=1.0, k=4 "
        f"(budget {PHASE18_BUDGET_S:.0f} s" + (", cut to Twitter: past 1,050 s" if cut else "") + ")")
    bench, same = _phase18_bench(names, held, dev)
    out = {"phase": 18, "card": smi, "budget_s": PHASE18_BUDGET_S, "cut": cut, "datasets": list(names)}
    ref = {}
    for name in names:
        six = held[name]["phase6"]
        if same[name]:
            say(f"phase 18: {name}: the log, the DiDiC map and its config are phase 6's; held to phase 6's figures")
            ref[name] = {"stress": six["stress"], "dynamic": six["dynamic"], "dynamic_s": six["dynamic_s"]}
            continue
        # Not shown to be phase 6's inputs: the meshless tables on these
        # inputs are the reference instead.
        say(f"phase 18: {name}: the log or map differs from phase 6's; held to the meshless tables instead")
        meshless = PaperBench(bench.cfg, device=dev)
        meshless._graphs, meshless._ops, meshless._parts = bench._graphs, bench._ops, dict(bench._parts)
        st, _, _ = _phase18_table(meshless, name, meshless.stress_experiment, {})
        dy, dy_s, _ = _phase18_table(meshless, name, meshless.dynamic_experiment, {})
        ref[name] = {"stress": {k: st[f"stress/{name}/{k}_pg"].value for k in ("base", "damaged", "repaired")},
                     "dynamic": [dy[f"dynamic/{name}/round{i + 1}/percent_global"].value for i in range(5)],
                     "dynamic_s": dy_s}
    t0 = time.perf_counter()
    _open_nccl_world1()
    try:
        mesh = make_replay_mesh(device=dev)
        check(dist.get_backend() == "nccl" and mesh.size == 1,
              f"phase 18: an NCCL group of {mesh.size} rank on {mesh.device}")
        out["group_s"] = time.perf_counter() - t0
        for name in names:
            one = PaperExperimentConfig(scale=1.0, datasets=(name,))
            res = out[name] = {}
            # (a) Stress, maintenance="shared": sharded replay, device-scan
            # dynamism, the single-device DiDiC; bit for bit phase 6's rows.
            rows, res["stress_s"], counts = _phase18_table(
                bench, name, lambda: bench.stress_experiment(mesh=mesh, maintenance="shared"), main_launches)
            want = ref[name]["stress"]
            got = {k: rows[f"stress/{name}/{k}_pg"].value for k in ("base", "damaged", "repaired")}
            check(list(rows) == row_names(one, "stress")
                  and all(got[k] == round(want[k], 3) for k in got),
                  f"phase 18 (a): {name} Stress on the mesh (shared DiDiC) == phase 6's rows: base {got['base']}, "
                  f"damaged {got['damaged']}, repaired {got['repaired']} T_G %")
            res["stress"] = got
            res["stress_launches"] = counts
            # (b) Dynamic, maintenance="auto": the mesh DiDiC, seeded from
            # the map; in the band of phase 6's maintained rounds; run twice,
            # every round, the final map and the carried w bit-equal.
            made, runtime_for = [], bench._runtime_for
            bench._runtime_for = lambda *a, **k: made.append(runtime_for(*a, **k)) or made[-1]
            try:
                rows, res["dynamic_s"], counts = _phase18_table(
                    bench, name, lambda: bench.dynamic_experiment(mesh=mesh), main_launches)
                again, res["dynamic_again_s"], _ = _phase18_table(
                    bench, name, lambda: bench.dynamic_experiment(mesh=mesh), {})
            finally:
                del bench._runtime_for
            check(list(rows) == row_names(one, "dynamic"),
                  f"phase 18 (b): {name} Dynamic row names == row_names(cfg, \"dynamic\")")
            first, second = (rt.service for rt in made)
            check(all(rows[k].value == again[k].value for k in rows if not k.endswith("/cycle_s"))
                  and _exact(made[0].last_result, made[1].last_result)
                  and np.array_equal(first.parts, second.parts)
                  and _bits_equal(first.runtime.state.w, second.runtime.state.w),
                  f"phase 18 (b): {name} Dynamic on the mesh DiDiC run twice: every round's T_G % and migrated "
                  f"count, the last slice's four counters, the final map and the carried w bit-equal "
                  f"({res['dynamic_s']:.2f} s, {res['dynamic_again_s']:.2f} s)")
            check(counts["segment_sum"] > 0, f"phase 18 (b): {name}'s mesh DiDiC summed through segment_sum "
                                             f"({counts['segment_sum']} launches)")
            rounds = [rows[f"dynamic/{name}/round{i + 1}/percent_global"].value for i in range(5)]
            migrated = [rows[f"dynamic/{name}/round{i + 1}/migrated_vertices"].value for i in range(5)]
            cyc = rows[f"dynamic/{name}/cycle_s"]
            a, b = PHASE18_BAND
            gaps = [abs(x - y) / 100 - (a * y / 100 + b) for x, y in zip(rounds, ref[name]["dynamic"])]
            check(max(gaps) <= 0, f"phase 18 (b): {name} Dynamic on the mesh DiDiC, every round's T_G % "
                                  f"within {a}·ref + {b} of phase 6's maintained round: "
                                  + ", ".join(f"{x:.3f} vs {y:.4f}" for x, y in zip(rounds, ref[name]["dynamic"])))
            unmaintained = held[name]["phase6"]["unmaintained"]
            check(rounds[-1] < unmaintained,
                  f"phase 18 (b): {name} round 5 T_G % {rounds[-1]:.3f} < phase 6's unmaintained {unmaintained:.4f}")
            check(cyc.derived.endswith("(resident device replay)"),
                  f"phase 18 (b): {name} cycle_s says {cyc.derived!r}")
            res.update(dynamic=rounds, migrated=migrated, cycle_s=cyc.value,
                       meshless_dynamic_s=ref[name]["dynamic_s"], dynamic_launches=counts)
            say(f"phase 18: {name} Dynamic cycle_s {cyc.value} s on the mesh against phase 6's meshless "
                f"{ref[name]['dynamic_s']:.2f} s for the same 5 slices; Stress {res['stress_s']:.2f} s, "
                f"Dynamic {res['dynamic_s']:.2f} s")
            if name == "gis":
                n = counts["frontier_gather"] + res["stress_launches"]["frontier_gather"]
                check(n > 0, f"phase 18: the GIS rows went through frontier_gather ({n} launches: Stress "
                             f"{res['stress_launches']['frontier_gather']}, Dynamic {counts['frontier_gather']}; "
                             f"a resident fold of the log re-solves nothing)")
    finally:
        dist.destroy_process_group()
    del bench
    out["phase_s"] = time.perf_counter() - t_phase
    say(json.dumps(out))
    say(f"phase 18: {out['phase_s']:.1f} s (budget {PHASE18_BUDGET_S:.0f} s"
        + (", over" if out["phase_s"] > PHASE18_BUDGET_S else "") + (", cut" if cut else "") + ")")


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
    phase1_flash_groups(dev)
    phase1_flash_backward(dev, records)
    phase1_segment_sum(dev, graphs, records)
    phase1_segment_spmm(dev, graphs, records)
    say(f"phase 1 done at {time.perf_counter() - t_start:.1f} s")

    main_launches = {}
    starts = {}
    held = {}
    for name, graph in graphs.items():
        starts[name] = phase2_dataset(name, graph, dev, main_launches, held)
        # phase 2's diffusion state, copied to the host for phase 18
        held[name]["state"] = tuple(getattr(starts[name][1], f).cpu().numpy() for f in ("w", "l", "parts", "beta"))
        say(f"phase 2 {name} done at {time.perf_counter() - t_start:.1f} s")
    gis_small, kernel_parts = phase3(dev, main_launches)
    say(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    for name, graph in graphs.items():
        phase6_dataset(name, graph, starts[name], dev, main_launches, held)
        say(f"phase 6 {name} done at {time.perf_counter() - t_start:.1f} s")
    phase6_bell(gis_small, kernel_parts, dev, main_launches)
    say(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")
    for name, graph in graphs.items():
        phase7_placement(name, graph, starts[name], dev, main_launches)
    phase7_skew(dev)
    phase7_tables(dev, main_launches)
    say(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")
    for name, graph in graphs.items():
        phase8_recovery(name, graph, starts[name], dev, main_launches)
        say(f"phase 8 {name} recovery done at {time.perf_counter() - t_start:.1f} s")
    phase8_online(graphs["gis"], starts["gis"], dev, main_launches)
    say(f"phase 8 online done at {time.perf_counter() - t_start:.1f} s")
    phase8_replicas(graphs["filesystem"], starts["filesystem"], dev, main_launches)
    say(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")
    for name, graph in graphs.items():
        held[name]["graph"] = _bare(graph)  # host arrays only; phase 12 builds its own engines
    del graphs, starts, gis_small
    torch.cuda.empty_cache()
    phase4_din(dev, records, main_launches)
    torch.cuda.empty_cache()
    say(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
    phase5_lm(dev, main_launches)
    say(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
    phase9_top_k_ties(dev)
    for module in PHASE9_CONFIGS:
        phase9_lm(module, dev, main_launches)
        say(f"phase 9 {module} done at {time.perf_counter() - t_start:.1f} s")
    phase10_granite(dev, main_launches)
    say(f"phase 10 granite done at {time.perf_counter() - t_start:.1f} s")
    phase10_launchers(dev, main_launches)
    say(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")
    t11 = time.perf_counter()
    for arch in GNN_ARCHS:
        phase11_gnn(arch, dev, smi, main_launches)
    say(f"phase 11a done at {time.perf_counter() - t_start:.1f} s")
    phase11_launchers(dev, smi)
    say(f"phase 11 done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t11:.1f} s)")
    phase12(held, dev, smi, main_launches)
    say(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
    phase13(held, dev, smi, main_launches, t_start)
    say(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
    phase14(held, dev, smi, main_launches, t_start)
    say(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")
    phase15(dev, smi, main_launches, t_start)
    say(f"phase 15 done at {time.perf_counter() - t_start:.1f} s")
    phase16(dev, smi, t_start)
    say(f"phase 16 done at {time.perf_counter() - t_start:.1f} s")
    phase17(dev, smi, main_launches, t_start)
    say(f"phase 17 done at {time.perf_counter() - t_start:.1f} s")
    phase18(held, dev, smi, main_launches, t_start)
    say(f"phase 18 done at {time.perf_counter() - t_start:.1f} s")
    say("main-path launches (the replays and DiDiC runs of phase 2, the two DiDiC routes of phase 3, "
        "user_vector in phase 4, the granite forward in phase 5, the replays and maintenance of "
        "phase 6, the replays and tables of phase 7, the uninterrupted, recovered and online runs "
        "of phase 8, the four forwards of phase 9, the training steps of phase 10, the sharded "
        "replays of phase 12, the mesh forward and the mesh online runs of phase 13, the replays and "
        "runs of phase 14, the EP training steps of phase 15, the TP step and the model ranks' "
        "attention of phase 17, the mesh tables of phase 18; segment_sum: the trainer steps of phase 11, "
        "the halo DiDiC of phase 12, the GCN of phase 13, the Dynamic tables of phase 18; segment_spmm: the "
        "DiDiC runs of phase 2 and every single-device DiDiC run inside the counted runs after them): "
        + json.dumps(main_launches, sort_keys=True))
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
