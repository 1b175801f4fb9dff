"""Checker framework for repro-lint over the port.

Twin of ``repro.analysis.framework`` with the port's lint root and file
config. The moving parts (see the package docstring for the why):

* :class:`Finding` — one violation, keyed for baseline suppression by
  ``rule|path|snippet`` (the *source text* of the flagged line, not its
  line number, so a baseline survives unrelated edits above it).
* :func:`rule` — registry decorator. ``scope="file"`` rules get a
  :class:`FileContext` per linted file; ``scope="repo"`` rules get one
  :class:`RepoContext` for cross-file checks (fault-site coverage).
* Per-file config (:data:`FILE_CONFIG`) and inline
  ``# repro-lint: disable[=rule,...]`` comments suppress findings at
  the source; the baseline file defers them visibly instead.
* :func:`run_lint` — the entry point: parse every file under the lint roots,
  run every enabled rule, apply suppressions.

Rule ids are hierarchical (``family/check``); suppressions and per-file
config match either the full id or the family prefix.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import json
import pathlib
import re
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "Rule",
    "RULES",
    "rule",
    "FileContext",
    "RepoContext",
    "FILE_CONFIG",
    "LINT_ROOTS",
    "collect_aliases",
    "resolve_name",
    "iter_source_files",
    "lint_file",
    "run_lint",
    "load_baseline",
    "write_baseline",
    "split_by_baseline",
]

#: Directories (repo-relative) whose ``*.py`` files the file-scope rules lint.
LINT_ROOTS: Tuple[str, ...] = ("src/repro_torch",)

#: Per-file rule opt-outs: repo-relative glob -> rule ids (or families)
#: disabled there. Prefer an inline ``# repro-lint: disable=...`` for a
#: single line; use this map when a whole file is legitimately exempt.
FILE_CONFIG: Dict[str, Set[str]] = {
    # The int64 hand-off implementation itself folds raw device counters —
    # that is its job; everyone else must go through it.
    "src/repro_torch/distributed/counters.py": {"counter-dtype"},
}

_DISABLE_RE = re.compile(r"#\s*repro-lint:\s*disable(?:=([\w/,\- ]+))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str          # repo-relative, posix separators
    line: int          # 1-based; 0 for file/repo-level findings
    message: str
    snippet: str = ""  # stripped source line — the baseline anchor

    @property
    def key(self) -> str:
        """Line-number-independent identity used for baseline matching."""
        return f"{self.rule}|{self.path}|{self.snippet or self.message}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    scope: str                     # "file" | "repo"
    fn: Callable[..., Iterator[Finding]]


RULES: Dict[str, Rule] = {}


def rule(name: str, doc: str, scope: str = "file"):
    """Register a rule. ``fn(ctx)`` yields :class:`Finding`s."""

    def deco(fn):
        RULES[name] = Rule(name, doc, scope, fn)
        return fn

    return deco


def _rule_matches(rule_id: str, pattern: str) -> bool:
    """``pattern`` matches a full rule id, a family prefix, or a glob."""
    return (
        rule_id == pattern
        or rule_id.startswith(pattern.rstrip("*").rstrip("/") + "/")
        or fnmatch.fnmatch(rule_id, pattern)
    )


# ---------------------------------------------------------------------------
# import-alias resolution (shared by several rules)
# ---------------------------------------------------------------------------
def collect_aliases(tree: ast.AST) -> Dict[str, str]:
    """Map local names to the dotted import path they are bound to.

    ``import numpy as np`` -> {"np": "numpy"}; ``from datetime import
    datetime`` -> {"datetime": "datetime.datetime"}.
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def resolve_name(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted path of a Name/Attribute chain with import aliases applied."""
    if isinstance(node, ast.Name):
        return aliases.get(node.id, node.id)
    if isinstance(node, ast.Attribute):
        prefix = resolve_name(node.value, aliases)
        return f"{prefix}.{node.attr}" if prefix else None
    return None


# ---------------------------------------------------------------------------
# contexts
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FileContext:
    """Everything a file-scope rule needs about one source file."""

    rel_path: str
    src: str
    tree: ast.AST
    lines: List[str]
    aliases: Dict[str, str]
    disabled: Set[str]                       # rules disabled for the file
    line_disabled: Dict[int, Optional[Set[str]]]  # lineno -> rules (None=all)
    # per-file results several rules share (the host-sync regions)
    memo: Dict[str, object] = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, path: pathlib.Path, rel_path: str) -> "FileContext":
        src = path.read_text()
        tree = ast.parse(src, filename=rel_path)
        lines = src.splitlines()
        line_disabled: Dict[int, Optional[Set[str]]] = {}
        for i, text in enumerate(lines, start=1):
            m = _DISABLE_RE.search(text)
            if m:
                names = m.group(1)
                line_disabled[i] = (
                    {n.strip() for n in names.split(",") if n.strip()}
                    if names else None
                )
        disabled: Set[str] = set()
        for glob, rules_off in FILE_CONFIG.items():
            if fnmatch.fnmatch(rel_path, glob):
                disabled |= rules_off
        return cls(rel_path, src, tree, lines, collect_aliases(tree),
                   disabled, line_disabled)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        lineno = getattr(node, "lineno", 0)
        return Finding(rule_id, self.rel_path, lineno, message,
                       snippet=self.line_text(lineno))

    def suppressed(self, f: Finding) -> bool:
        for pat in self.disabled:
            if _rule_matches(f.rule, pat):
                return True
        rules_off = self.line_disabled.get(f.line, ...)
        if rules_off is None:          # bare `disable`
            return True
        if rules_off is not ...:
            return any(_rule_matches(f.rule, p) for p in rules_off)
        return False


@dataclasses.dataclass
class RepoContext:
    """Whole-tree view for cross-file rules (fault-site coverage)."""

    root: pathlib.Path
    files: List[pathlib.Path]

    def rel(self, path: pathlib.Path) -> str:
        return path.relative_to(self.root).as_posix()

    def parse(self, path: pathlib.Path) -> FileContext:
        return FileContext.parse(path, self.rel(path))


# ---------------------------------------------------------------------------
# running the rules
# ---------------------------------------------------------------------------
def iter_source_files(root: pathlib.Path,
                      roots: Sequence[str] = LINT_ROOTS) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for sub in roots:
        base = root / sub
        if base.is_file():
            files.append(base)
        elif base.is_dir():
            files.extend(sorted(base.rglob("*.py")))
    return files


def _enabled(rules: Optional[Sequence[str]], scope: str) -> List[Rule]:
    out = []
    for r in RULES.values():
        if r.scope != scope:
            continue
        if rules is not None and not any(_rule_matches(r.name, p) for p in rules):
            continue
        out.append(r)
    return out


def lint_file(path: pathlib.Path, root: Optional[pathlib.Path] = None,
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run file-scope rules over one file (test fixtures use this)."""
    rel = path.relative_to(root).as_posix() if root else path.name
    ctx = FileContext.parse(path, rel)
    findings: List[Finding] = []
    for r in _enabled(rules, "file"):
        for f in r.fn(ctx):
            if not ctx.suppressed(f):
                findings.append(f)
    return findings


def run_lint(root: pathlib.Path, rules: Optional[Sequence[str]] = None,
             roots: Sequence[str] = LINT_ROOTS,
             repo_rules: bool = True) -> List[Finding]:
    """Run all enabled rules over the repo; returns unsuppressed findings."""
    root = pathlib.Path(root)
    files = iter_source_files(root, roots)
    findings: List[Finding] = []
    for path in files:
        findings.extend(lint_file(path, root=root, rules=rules))
    if repo_rules:
        ctx = RepoContext(root=root, files=files)
        for r in _enabled(rules, "repo"):
            findings.extend(r.fn(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------
def load_baseline(path: pathlib.Path) -> Dict[str, Dict]:
    """Baseline entries keyed like :attr:`Finding.key`."""
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    out: Dict[str, Dict] = {}
    for e in data.get("findings", []):
        key = f"{e['rule']}|{e['path']}|{e['snippet']}"
        out[key] = e
    return out


def write_baseline(findings: Iterable[Finding], path: pathlib.Path,
                   notes: Optional[Dict[str, str]] = None) -> None:
    entries = []
    seen = set()
    for f in sorted(findings, key=lambda f: f.key):
        if f.key in seen:
            continue
        seen.add(f.key)
        e = {"rule": f.rule, "path": f.path, "snippet": f.snippet or f.message}
        if notes and f.key in notes:
            e["note"] = notes[f.key]
        entries.append(e)
    payload = {
        "comment": ("Deferred repro-lint findings. Entries are keyed by "
                    "rule|path|snippet (line-number independent); the lint "
                    "fails only on findings NOT listed here. Remove an entry "
                    "once its finding is fixed."),
        "findings": entries,
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")


def split_by_baseline(
    findings: Sequence[Finding], baseline: Dict[str, Dict]
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """-> (new, baseline-suppressed, stale baseline keys)."""
    new: List[Finding] = []
    suppressed: List[Finding] = []
    hit: Set[str] = set()
    for f in findings:
        if f.key in baseline:
            suppressed.append(f)
            hit.add(f.key)
        else:
            new.append(f)
    stale = sorted(set(baseline) - hit)
    return new, suppressed, stale
