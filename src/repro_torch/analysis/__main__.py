"""CLI: ``python -m repro_torch.analysis`` (twin of ``python -m
repro.analysis``).

Exit status 0 iff no findings outside ``baseline.json``. The JSON and
text reports are always written when ``--json``/``--report`` are given —
also on failure — so CI can upload them as artifacts unconditionally.
The rebuild sentinel runs on the card by default (``--device cpu`` runs
it on the CPU; without CUDA and without ``--device cpu`` it raises);
``--no-recompile`` runs the static rules alone and needs no device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import repro_torch.analysis as A
from repro_torch.analysis import recompile, report


def _repo_root(start: pathlib.Path) -> pathlib.Path:
    for cand in (start, *start.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return start


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint: static invariant analysis for the port",
    )
    p.add_argument("--root", type=pathlib.Path,
                   default=_repo_root(pathlib.Path.cwd()),
                   help="repo root (default: auto-detected from cwd)")
    p.add_argument("--baseline", type=pathlib.Path, default=None,
                   help="baseline file (default: src/repro_torch/analysis/baseline.json)")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline from the current findings")
    p.add_argument("--json", type=pathlib.Path, default=None,
                   help="write the JSON report here")
    p.add_argument("--report", type=pathlib.Path, default=None,
                   help="write the human-readable report here")
    p.add_argument("--rule", action="append", default=None,
                   help="only run matching rules (repeatable; family prefixes ok)")
    sent = p.add_mutually_exclusive_group()
    sent.add_argument("--recompile", dest="recompile", action="store_true",
                      default=True, help="run the rebuild sentinel (default)")
    sent.add_argument("--no-recompile", dest="recompile", action="store_false")
    p.add_argument("--slices", type=int, default=20,
                   help="sentinel growth slices (default 20)")
    p.add_argument("--amount", type=float, default=0.05,
                   help="sentinel dynamism amount per slice (default 0.05)")
    p.add_argument("--insert-rate", type=float, default=0.5,
                   help="sentinel vertex-insert share of dynamism (default 0.5)")
    p.add_argument("--scale", type=float, default=0.002,
                   help="sentinel dataset scale (default 0.002)")
    p.add_argument("--device", default=None,
                   help="where the sentinel runs (default: cuda)")
    args = p.parse_args(argv)

    root = args.root.resolve()
    baseline_path = args.baseline or (
        root / "src" / "repro_torch" / "analysis" / "baseline.json"
    )

    findings = A.run_lint(root, rules=args.rule)

    sentinel_report = None
    if args.recompile:
        sentinel_report = recompile.run_growth_sentinel(
            slices=args.slices, amount=args.amount,
            insert_rate=args.insert_rate, scale=args.scale, root=root,
            device=args.device,
        )
        findings.extend(
            recompile.findings_from_report(sentinel_report, root))

    if args.write_baseline:
        A.write_baseline(findings, baseline_path)
        print(f"wrote {len(set(f.key for f in findings))} baseline entries "
              f"to {baseline_path}")
        return 0

    baseline = A.load_baseline(baseline_path)
    new, suppressed, stale = A.split_by_baseline(findings, baseline)

    payload = report.build_payload(new, suppressed, stale, sentinel_report)
    text = report.render_text(new, suppressed, stale, sentinel_report)
    report.write_reports(payload, text, json_path=args.json,
                         text_path=args.report)
    sys.stdout.write(text)
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
