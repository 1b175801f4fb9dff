"""Time one kernel of this checkout against the same kernel of another
checkout, in turns, on one card.

    python3 kernel_ab.py --other DIR [--phase phase1_bell]
    python3 kernel_ab.py --other DIR --phase frontier_gather
    python3 kernel_ab.py --other DIR --phase embedding_bag
    python3 kernel_ab.py --other DIR --phase flash_attention_bwd
    python3 kernel_ab.py --other DIR --phase segment_sum

``DIR`` is the root of another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.
Every turn (other, this, this, other) is a fresh process in one checkout:
it builds that checkout's kernels into its own ``build/`` and times that
checkout's kernel.

* ``--phase frontier_gather``, ``--phase embedding_bag``, ``--phase
  flash_attention_bwd`` and ``--phase segment_sum`` are run by this
  script's own code in each checkout, so they need nothing of the other
  checkout but its wrapper, called by its signature.
  ``frontier_gather``: the GIS whole-graph layout at ``scale=1.0``
  (786,432 rows, C = 128, min mode, values drawn from seed 1 as in
  ``chip_smoke.py``), called without a row schedule and, where the
  checkout's engine has one (``full_row_order``), with it.
  ``embedding_bag``: DIN's item table (``configs/din.FULL``, seed 0) and
  its 262,144 histories of 100 (``din_batch`` seed 0) with mean weights.
  ``flash_attention_bwd``: granite-3-8b's prefill shape (Hq 32, Hkv 8, T
  4,096, Dh 128, causal, bf16; inputs drawn from seed 4), the checkout's
  ``ops._kernel_call(..., with_lse=True)`` and then ``ops._bwd_kernel_call``
  on its output and log-sum-exp; SDPA's backward alone on the same inputs
  (``autograd.grad`` on a retained graph) is timed beside it as
  ``sdpa_backward``.
  ``segment_sum``: ``chip_smoke.py`` phase 1's products, Twitter's
  ``[1,687,060x4]`` and GIS's ``[4,239,526x32]`` (both at ``scale=1.0``,
  features from seed 5), and phase 11's sampled GraphSAGE block's gather
  backward ``[10,240x128]`` (reddit_like, ``NeighborSampler((15, 10))``,
  its first 1,024-node batch, gradient from seed 6), each held bit for bit
  to the plain version on the CPU; beside ``ms`` and ``b2b_ms`` the device
  time a call (``device_ms``, ``torch.profiler`` over 10 calls) and
  ``index_add_``'s times (``library_ms``, ``library_b2b_ms``). With
  ``--long-segment 64,128,...`` the three are also timed with the
  checkout's ``ops.LONG_SEGMENT`` set to each value (records
  ``segment_sum_twitter_long_64``, ...), each held bit for bit to the plain version on the CPU.
  Each call is held to the plain version (min mode bit-exact, the bag
  within 1e-6, the backward within 3e-2 of ``attention_bwd_lse_ref``) and
  timed as ``chip_smoke.py`` times kernels: one call between two CUDA
  events (``ms``) and a call's share of 10 back to back (``b2b_ms``),
  medians of 10.
* Any other ``--phase`` is a ``chip_smoke.py`` phase function of that
  checkout that takes ``(device, records)`` (``phase1_bell``,
  ``phase1_flash``); it holds the kernel to its plain version and times it
  with that checkout's ``time_cuda``.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
with every turn's times. Exits non-zero when a turn fails or no CUDA device
is present.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

THIS = os.path.dirname(os.path.abspath(__file__))
MARK = "KERNEL_AB "
TIMES = ("ms", "b2b_ms", "device_ms", "plain_ms", "library_ms", "library_b2b_ms", "shape")
TURN = f"""
import json, statistics, sys, torch
sys.path.insert(0, ".")
sys.path.insert(0, "src")
from repro_torch import kernels
if not torch.cuda.is_available():
    sys.exit("kernel_ab: needs a CUDA device")
kernels.build_all()
dev = torch.device("cuda")


def time_cuda(fn, inner=1, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def timed(fn):
    return {{"ms": time_cuda(fn), "b2b_ms": time_cuda(fn, inner=10)}}


def frontier_gather(records):
    from repro_torch.core.traffic_batched import get_engine
    from repro_torch.graphs import datasets
    from repro_torch.kernels.frontier import frontier_gather, frontier_gather_ref

    eng = get_engine(datasets.load("gis", scale=1.0, seed=0), "gis_short", device=dev)
    w_pad, nbr, w_inf = eng.ensure_full_layout()[:3]
    g = torch.rand((w_pad, 128), generator=torch.Generator(device=dev).manual_seed(1), device=dev) * 5.0
    g[torch.rand((w_pad, 128), device=dev) < 0.5] = float("inf")
    want = frontier_gather_ref(g, nbr, w_inf, mode="min")
    calls = {{"frontier_gather": lambda: frontier_gather(g, nbr, w_inf, mode="min")}}
    if hasattr(eng, "full_row_order"):
        order = eng.full_row_order()
        calls["frontier_gather_ordered"] = lambda: frontier_gather(g, nbr, w_inf, mode="min", order=order)
    for name, fn in calls.items():
        if not torch.equal(fn(), want):
            sys.exit(f"kernel_ab: {{name}} differs from the plain version")
        records[name] = timed(fn)


def embedding_bag(records):
    from repro_torch.configs.din import FULL
    from repro_torch.data.pipeline import din_batch
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
    from repro_torch.models import recsys

    params = recsys.init(FULL, torch.Generator(device=dev).manual_seed(0), device=dev)
    host = din_batch(262_144, FULL.seq_len, FULL.n_items, FULL.n_cats, seed=0)
    table = params["item_embed"]
    idx = torch.as_tensor(host["hist_items"], device=dev)
    mask = torch.as_tensor(host["hist_mask"], device=dev)
    w = mask / torch.clamp(mask.sum(dim=1, keepdim=True), min=1e-9)
    fn = lambda: embedding_bag(table, idx, w)
    if not torch.allclose(fn(), embedding_bag_ref(table, idx, w), rtol=1e-6, atol=1e-6):
        sys.exit("kernel_ab: embedding_bag differs from the plain version")
    records["embedding_bag"] = timed(fn)


def flash_attention_bwd(records):
    import numpy as np
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_lse_ref

    hq, hkv, t, dh = 32, 8, 4096, 128
    rng = np.random.default_rng(4)
    q, k, v, dout = (torch.as_tensor(rng.normal(size=(h, t, dh)).astype(np.float32), device=dev).to(torch.bfloat16)
                     for h in (hq, hkv, hkv, hq))
    o, lse = ops._kernel_call(q, k, v, causal=True, q_offset=0, with_lse=True)
    fn = lambda: ops._bwd_kernel_call(q, k, v, o, lse, dout, causal=True, q_offset=0)
    want = attention_bwd_lse_ref(q, k, v, o, lse, dout, causal=True, q_offset=0)
    if not all(torch.allclose(g.float(), w.float(), rtol=3e-2, atol=3e-2) for g, w in zip(fn(), want)):
        sys.exit("kernel_ab: flash_attention_bwd differs from the plain o/lse backward")
    del want
    records["flash_attention_bwd"] = timed(fn)
    q4, k4, v4 = (x[None].detach().requires_grad_(True) for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=True)
    records["sdpa_backward"] = timed(lambda: torch.autograd.grad(out, (q4, k4, v4), dout[None], retain_graph=True))


def device_ms(fn, kernel, calls=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key)
    return total / 1e3 / calls if total > 0 else None


def segment_sum(records):
    import numpy as np
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.graphs import datasets
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref

    cases = {{}}
    rng = np.random.default_rng(5)
    for name, f in (("twitter", 4), ("gis", 32)):
        g = datasets.load(name, scale=1.0, seed=0)
        s, r, w = g.undirected
        x = torch.as_tensor(rng.standard_normal((g.n_nodes, f)).astype(np.float32), device=dev)
        data = torch.as_tensor(w, dtype=torch.float32, device=dev)[:, None] * x[torch.as_tensor(s, device=dev).long()]
        cases[name] = (data, torch.as_tensor(r, device=dev), g.n_nodes)
    shape = GNN_SHAPES["minibatch_lg"]
    ns = NeighborSampler(datasets.load("reddit_like", scale=1.0), shape["fanout"], seed=0)
    outer, inner = ns.sample_batch(next(ns.batches(shape["batch_nodes"], 5, seed=1)))
    nbrs = torch.as_tensor(inner.neighbors, device=dev).reshape(-1)
    grad = torch.as_tensor(np.random.default_rng(6).standard_normal((nbrs.numel(), 128)).astype(np.float32),
                           device=dev)
    cases["sage_block"] = (grad, nbrs, int(outer.neighbors.shape[0]))
    wants = {{name: segment_sum_ref(data.cpu(), ids.cpu().long(), n) for name, (data, ids, n) in cases.items()}}
    for name, (data, ids, n) in cases.items():
        fn = lambda: segment_sum(data, ids, n)
        if not torch.equal(fn().cpu().view(torch.int32), wants[name].view(torch.int32)):
            sys.exit(f"kernel_ab: segment_sum {{name}} differs from the plain version on the CPU")
        lib = lambda: torch.zeros((n, data.shape[1]), device=dev).index_add_(0, ids, data)
        records["segment_sum_" + name] = {{
            **timed(fn), "device_ms": device_ms(fn, "segment_sum"), "library_ms": time_cuda(lib),
            "library_b2b_ms": time_cuda(lib, inner=10), "shape": [*data.shape, n]}}
    from repro_torch.kernels.segment_sum import ops
    default = ops.LONG_SEGMENT
    for at in THRESHOLDS:
        ops.LONG_SEGMENT = at
        for name in cases:
            data, ids, n = cases[name]
            ids = ids.clone()  # a fresh grouping at this threshold
            fn = lambda: segment_sum(data, ids, n)
            if not torch.equal(fn().cpu().view(torch.int32), wants[name].view(torch.int32)):
                sys.exit(f"kernel_ab: segment_sum {{name}} at LONG_SEGMENT {{at}} differs from the plain version")
            records[f"segment_sum_{{name}}_long_{{at}}"] = {{**timed(fn), "device_ms": device_ms(fn, "segment_sum")}}
    ops.LONG_SEGMENT = default


records = {{}}
phase = sys.argv[1]
THRESHOLDS = [int(x) for x in sys.argv[2].split(",") if x]
if phase in ("frontier_gather", "embedding_bag", "flash_attention_bwd", "segment_sum"):
    globals()[phase](records)
else:
    import chip_smoke
    getattr(chip_smoke, phase)(dev, records)
print({MARK!r} + json.dumps({{n: {{k: r[k] for k in {TIMES!r} if k in r}} for n, r in records.items()}}))
"""


def turn(root: str, phase: str, thresholds: str = "") -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN, phase, thresholds], cwd=root, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"kernel_ab: {phase} failed in {root} (exit code {proc.returncode})")
    line = [x for x in proc.stdout.splitlines() if x.startswith(MARK)][-1]
    return json.loads(line[len(MARK):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--phase", default="phase1_bell",
                    help="frontier_gather, embedding_bag, flash_attention_bwd, segment_sum, or a chip_smoke.py "
                         "phase function")
    ap.add_argument("--long-segment", default="",
                    help="segment_sum only: also time the three shapes with LONG_SEGMENT set to each of these "
                         "comma-separated values (a checkout whose grouping has the threshold)")
    args = ap.parse_args(argv)
    roots = {"other": os.path.abspath(args.other), "this": THIS}
    turns = [{"side": side, "records": turn(roots[side], args.phase, args.long_segment)}
             for side in ("other", "this", "this", "other")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps({"phase": args.phase, "other": roots["other"], "turns": turns}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
