"""Fault-site coverage rules (repo scope; twin of
``repro.analysis.faultsites``).

The recovery layer's guarantees are only as good as its test coverage:
a crash site fired in ``src/`` but never exercised by a recovery test is
an untested failure mode, and a site string not in the
``repro_torch.core.fault.FAULT_SITES`` registry is a typo waiting to no-op.
This rule family cross-checks three sources of truth:

1. every literal site fired via ``<plan>.fire("...")`` anywhere under
   the lint roots (``src/repro_torch``),
2. the machine-readable registry ``FAULT_SITES`` in ``core/fault.py``
   (the contract: register -> fire -> test; see its docstring),
3. the sites exercised by the port's crash tests (``COVERAGE_TESTS``:
   the recovery tests, and the online server's, which crash at the
   ``serve:`` sites) — via
   ``.crash(..., site=...)`` (default ``apply:pre_commit``),
   ``.timeout_maintenance(...)`` (exercises ``maintain``), or a direct
   ``.fire("...")``.

Findings: ``fault-sites/unknown`` (fired but unregistered),
``fault-sites/untested`` (fired but no recovery test reaches it),
``fault-sites/unfired`` (registered but dead), and
``fault-sites/dynamic`` (non-literal site argument — statically
unverifiable; thread a literal through instead).
"""

from __future__ import annotations

import ast
import pathlib
from typing import Dict, Iterator, List, Set, Tuple

from repro_torch.analysis.framework import Finding, RepoContext, rule

#: Test files whose fault schedules count as coverage.
COVERAGE_TESTS = ("tests/test_torch_recovery.py", "tests/test_torch_online.py")

_DEFAULT_CRASH_SITE = "apply:pre_commit"


def _literal(node: ast.AST):
    return node.value if isinstance(node, ast.Constant) else None


def fired_sites(ctx: RepoContext) -> Tuple[List[Tuple[str, str, int]],
                                           List[Tuple[str, int]]]:
    """-> ([(site, rel_path, lineno)], [(rel_path, lineno) dynamic])."""
    fired: List[Tuple[str, str, int]] = []
    dynamic: List[Tuple[str, int]] = []
    for path in ctx.files:
        tree = ast.parse(path.read_text(), filename=str(path))
        rel = ctx.rel(path)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fire"):
                continue
            if not node.args:
                continue
            site = _literal(node.args[0])
            if isinstance(site, str):
                fired.append((site, rel, node.lineno))
            else:
                dynamic.append((rel, node.lineno))
    return fired, dynamic


def tested_sites(root: pathlib.Path,
                 test_files: Tuple[str, ...] = COVERAGE_TESTS) -> Set[str]:
    sites: Set[str] = set()
    for rel in test_files:
        path = root / rel
        if not path.exists():
            continue
        tree = ast.parse(path.read_text(), filename=rel)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr == "crash":
                site = _DEFAULT_CRASH_SITE
                for kw in node.keywords:
                    if kw.arg == "site":
                        site = _literal(kw.value)
                if len(node.args) >= 2:
                    site = _literal(node.args[1])
                if isinstance(site, str):
                    sites.add(site)
            elif attr == "timeout_maintenance":
                sites.add("maintain")
            elif attr == "fire" and node.args:
                site = _literal(node.args[0])
                if isinstance(site, str):
                    sites.add(site)
    return sites


def registry_sites() -> Dict[str, str]:
    from repro_torch.core.fault import FAULT_SITES

    return dict(FAULT_SITES)


@rule("fault-sites/coverage",
      "every fired fault site is registered and exercised by a recovery test",
      scope="repo")
def check_fault_sites(ctx: RepoContext) -> Iterator[Finding]:
    registry = registry_sites()
    fired, dynamic = fired_sites(ctx)
    tested = tested_sites(ctx.root)

    for rel, lineno in dynamic:
        yield Finding(
            "fault-sites/dynamic", rel, lineno,
            "FaultPlan.fire() with a non-literal site cannot be checked "
            "against the registry; pass a literal site string",
            snippet=f"dynamic fire @ {rel}",
        )

    seen_fired: Set[str] = set()
    for site, rel, lineno in fired:
        if site not in registry:
            yield Finding(
                "fault-sites/unknown", rel, lineno,
                f"fired site {site!r} is not in core.fault.FAULT_SITES — "
                f"register it (and add a recovery test) or fix the typo",
                snippet=f"site {site}",
            )
        elif site not in tested and site not in seen_fired:
            yield Finding(
                "fault-sites/untested", rel, lineno,
                f"fired site {site!r} is never exercised by "
                f"{', '.join(COVERAGE_TESTS)} — add a crash/timeout test "
                f"reaching it",
                snippet=f"site {site}",
            )
        seen_fired.add(site)

    for site in sorted(set(registry) - seen_fired):
        yield Finding(
            "fault-sites/unfired", "src/repro_torch/core/fault.py", 0,
            f"registered site {site!r} is never fired under "
            f"{'/'.join(('src', 'repro_torch'))} — dead registry entry",
            snippet=f"site {site}",
        )
