"""Time one kernel of this checkout against the same kernel of another
checkout, in turns, on one card.

    python3 kernel_ab.py --other DIR [--phase phase1_bell]
    python3 kernel_ab.py --other DIR --phase frontier_gather
    python3 kernel_ab.py --other DIR --phase embedding_bag

``DIR`` is the root of another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.
Every turn (other, this, this, other) is a fresh process in one checkout:
it builds that checkout's kernels into its own ``build/`` and times that
checkout's kernel.

* ``--phase frontier_gather`` and ``--phase embedding_bag`` are run by this
  script's own code in each checkout, so they need nothing of the other
  checkout but its public wrapper, called by its positional signature.
  ``frontier_gather``: the GIS whole-graph layout at ``scale=1.0``
  (786,432 rows, C = 128, min mode, values drawn from seed 1 as in
  ``chip_smoke.py``), called without a row schedule and, where the
  checkout's engine has one (``full_row_order``), with it.
  ``embedding_bag``: DIN's item table (``configs/din.FULL``, seed 0) and
  its 262,144 histories of 100 (``din_batch`` seed 0) with mean weights.
  Each call is held to the plain version (min mode bit-exact, the bag
  within 1e-6) and timed as ``chip_smoke.py`` times kernels: one call
  between two CUDA events (``ms``) and a call's share of 10 back to back
  (``b2b_ms``), medians of 10.
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
TIMES = ("ms", "b2b_ms", "plain_ms", "library_ms")
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


records = {{}}
phase = sys.argv[1]
if phase in ("frontier_gather", "embedding_bag"):
    globals()[phase](records)
else:
    import chip_smoke
    getattr(chip_smoke, phase)(dev, records)
print({MARK!r} + json.dumps({{n: {{k: r[k] for k in {TIMES!r} if k in r}} for n, r in records.items()}}))
"""


def turn(root: str, phase: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN, phase], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"kernel_ab: {phase} failed in {root} (exit code {proc.returncode})")
    line = [x for x in proc.stdout.splitlines() if x.startswith(MARK)][-1]
    return json.loads(line[len(MARK):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--phase", default="phase1_bell",
                    help="frontier_gather, embedding_bag, or a chip_smoke.py phase function")
    args = ap.parse_args(argv)
    roots = {"other": os.path.abspath(args.other), "this": THIS}
    turns = [{"side": side, "records": turn(roots[side], args.phase)}
             for side in ("other", "this", "this", "other")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps({"phase": args.phase, "other": roots["other"], "turns": turns}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
