"""Placement single-owner rule (repo scope; twin of
``repro.analysis.placement``).

The partition map lives behind
:class:`repro_torch.core.placement.Placement`: ``owner`` is the single
source of truth and the hot-vertex exception table must be invalidated
whenever ownership changes. A direct in-place write to a ``parts`` array
(``parts[v] = p`` or ``svc.parts[v] = p``) bypasses
``Placement.replace_owner`` / ``Placement.invalidate`` and silently
leaves stale replicas behind — reads route locally to a replica whose
owner moved, and the three traffic engines diverge.

``placement/single-owner`` therefore flags any subscript assignment
(plain or augmented) whose target is a name or attribute called
``parts``, anywhere under the lint roots, except in the two modules
that legitimately build partition arrays from scratch:

* ``core/placement.py`` — the ownership model itself;
* ``core/partitioners.py`` — constructs fresh local ``parts`` arrays
  before any Placement exists.

Everything else must either build a *new* array under a different name
and hand it to ``Service.parts`` (the property setter routes through
``replace_owner``) or call the Placement API directly.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.framework import Finding, RepoContext, rule

#: Modules allowed to write ``parts[...]`` directly (relative paths).
ALLOWED_FILES = (
    "src/repro_torch/core/placement.py",
    "src/repro_torch/core/partitioners.py",
)


def _is_parts_target(node: ast.AST) -> bool:
    """True for ``parts[...]`` / ``<expr>.parts[...]`` subscript targets."""
    if not isinstance(node, ast.Subscript):
        return False
    value = node.value
    if isinstance(value, ast.Name):
        return value.id == "parts"
    if isinstance(value, ast.Attribute):
        return value.attr == "parts"
    return False


def _assign_targets(node: ast.AST):
    if isinstance(node, ast.Assign):
        return node.targets
    if isinstance(node, ast.AugAssign):
        return [node.target]
    return []


@rule("placement/single-owner",
      "partition ownership is only mutated through the Placement API",
      scope="repo")
def check_single_owner(ctx: RepoContext) -> Iterator[Finding]:
    for path in ctx.files:
        rel = ctx.rel(path)
        if rel in ALLOWED_FILES:
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            for target in _assign_targets(node):
                if not _is_parts_target(target):
                    continue
                yield Finding(
                    "placement/single-owner", rel, node.lineno,
                    "direct write to a parts array bypasses the Placement "
                    "ownership model (replicas are not invalidated); build "
                    "a new array and assign via Service.parts, or use "
                    "Placement.replace_owner/invalidate",
                    snippet="parts[...] write",
                )
