"""Time one kernel of this checkout against the same kernel of another
checkout, in turns, on one card.

    python3 kernel_ab.py --other DIR [--phase phase1_bell]

``DIR`` is the root of another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.
Every turn (other, this, this, other) is a fresh process in
one checkout: it builds that checkout's kernels into its own ``build/`` and
runs that checkout's own ``chip_smoke.py`` phase function, which holds the
kernel to its plain version and times it with that checkout's
``time_cuda``. Any phase function that takes ``(device, records)`` will do
(``phase1_bell``, ``phase1_flash``). Prints the card's ``nvidia-smi`` name
and power limit, then one JSON line with every turn's times. Exits non-zero
when a turn fails or no CUDA device is present.
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
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke
from repro_torch import kernels
if not torch.cuda.is_available():
    sys.exit("kernel_ab: needs a CUDA device")
kernels.build_all()
records = {{}}
getattr(chip_smoke, sys.argv[1])(torch.device("cuda"), records)
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
    ap.add_argument("--phase", default="phase1_bell", help="chip_smoke.py phase function to run")
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
