"""Counter-dtype rule family (twin of ``repro.analysis.counterdtype``).

Device-side traffic counters are int32 (the sharded replay accumulates
waves as ``torch.int32`` for speed and collective width); host-side
totals are int64, and the *only* sanctioned crossing is
``repro_torch.distributed.counters.CounterAccumulator`` (and the
``make_scatter_psum`` helper), which widens each wave to int64 on the
host before folding. Accumulating a raw device reduction (a
``sum(..., dtype=int32)``, a ``*psum`` all-reduce, a ``scatter_psum``
result) straight into a running total keeps the fold in int32 — the
~1M-op logs the benchmarks target overflow 31 bits — so any
``+=``/``-=`` whose right-hand side is such a reduction is flagged unless
the file is the hand-off implementation itself (see ``FILE_CONFIG`` in
:mod:`repro_torch.analysis.framework`).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.framework import (
    FileContext,
    Finding,
    resolve_name,
    rule,
)

_INT32_NAMES = {"torch.int32", "numpy.int32", "int32"}


def _is_int32(node: ast.AST, aliases) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "int32"
    return resolve_name(node, aliases) in _INT32_NAMES


def _device_counter_fold(node: ast.Call, aliases) -> Optional[str]:
    """Why ``node`` is a raw device counter reduction, or None."""
    name = resolve_name(node.func, aliases)
    if name is not None:
        tail = name.rsplit(".", 1)[-1]
        if tail == "psum":
            return "a psum folds counters across shards in device dtype"
        if "scatter_psum" in tail:
            return "scatter_psum returns per-row int32 wave counts"
    is_sum = False
    if isinstance(node.func, ast.Attribute) and node.func.attr == "sum":
        is_sum = True
    if name is not None and name.rsplit(".", 1)[-1] == "sum":
        is_sum = True
    if is_sum:
        for kw in node.keywords:
            if kw.arg == "dtype" and _is_int32(kw.value, aliases):
                return "sum(..., dtype=int32) wave accumulation"
    return None


@rule("counter-dtype/raw-accumulation",
      "int32 device counter folded into an accumulator outside the "
      "CounterAccumulator int64 hand-off")
def check_raw_accumulation(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.AugAssign):
            continue
        if not isinstance(node.op, (ast.Add, ast.Sub)):
            continue
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Call):
                why = _device_counter_fold(sub, ctx.aliases)
                if why:
                    yield ctx.finding(
                        "counter-dtype/raw-accumulation", node,
                        f"{why}; route the fold through "
                        f"distributed/counters.py (CounterAccumulator.add "
                        f"widens each wave to int64 before accumulating)",
                    )
                    break
