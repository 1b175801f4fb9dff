"""Lint report rendering: JSON (machine) + text (human) forms (twin of
``repro.analysis.report``, the sentinel's lines in rebuilds and
refreshes).

CI uploads both as artifacts next to the junit XML; the text form is
also what ``python -m repro_torch.analysis`` prints. Baseline-suppressed findings are always
listed explicitly — a deferred finding is a tracked debt, not a hidden
one.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.framework import RULES, Finding


def build_payload(
    new: Sequence[Finding],
    suppressed: Sequence[Finding],
    stale: Sequence[str],
    sentinel_report: Optional[Dict] = None,
) -> Dict:
    return {
        "tool": "repro-lint",
        "rules": {name: r.doc for name, r in sorted(RULES.items())},
        "new_findings": [f.to_json() for f in new],
        "baseline_suppressed": [f.to_json() for f in suppressed],
        "stale_baseline_keys": list(stale),
        "recompile_sentinel": sentinel_report,
        "ok": not new,
    }


def render_text(
    new: Sequence[Finding],
    suppressed: Sequence[Finding],
    stale: Sequence[str],
    sentinel_report: Optional[Dict] = None,
) -> str:
    lines: List[str] = []
    add = lines.append
    add(f"repro-lint: {len(new)} new finding(s), "
        f"{len(suppressed)} baseline-suppressed, "
        f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'}")
    if new:
        add("")
        add("== NEW findings (fail the build) ==")
        for f in new:
            add(f"  {f.format()}")
    if suppressed:
        add("")
        add("== baseline-suppressed (deferred, tracked in baseline.json) ==")
        for f in suppressed:
            add(f"  {f.format()}")
    if stale:
        add("")
        add("== stale baseline entries (finding fixed — remove from baseline.json) ==")
        for key in stale:
            add(f"  {key}")
    if sentinel_report is not None:
        sched = sentinel_report["schedule"]
        add("")
        add(f"== rebuild sentinel ({sched['slices']}x{sched['amount']:.0%} "
            f"growth schedule, insert_rate={sched['insert_rate']}, "
            f"on {sentinel_report['device']}) ==")
        total = sentinel_report["total_rebuilds_after_warmup"]
        add(f"  rebuilds after slice 0: {total} "
            f"(steady-state: {'yes' if sentinel_report['steady_state'] else 'NO'}); "
            f"table refreshes: {sentinel_report['total_refreshes']}")
        for s in sentinel_report["per_slice"]:
            add(f"    slice {s['slice']:>2}: {s['rebuilds']:>3} rebuilds "
                f"{s['refreshes']:>3} refreshes {s['seconds']:>7.3f}s  "
                f"n_nodes={s['n_nodes']}")
        if sentinel_report["retraces"]:
            add("  rebuilt objects:")
            for r in sentinel_report["retraces"]:
                add(f"    {r['closure']:<28} {r['cause']:<16} "
                    f"{r['count']:>3}x over {len(r['slices'])} slices")
                add(f"      {r['detail']}")
    add("")
    add("OK" if not new else "FAIL (new findings above — fix them or, if "
        "deliberately deferred, add to baseline.json via --write-baseline)")
    return "\n".join(lines) + "\n"


def write_reports(payload: Dict, text: str, json_path=None, text_path=None) -> None:
    if json_path:
        json_path.write_text(
            json.dumps(payload, indent=2, sort_keys=True) + "\n")
    if text_path:
        text_path.write_text(text)
