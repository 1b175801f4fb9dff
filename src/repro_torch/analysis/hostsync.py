"""Host-sync rule family (twin of ``repro.analysis.hostsync``).

A compiled or captured hot path must never force a device→host transfer
inside it: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, builtin
``int()/float()/bool()`` on a device value, and ``np.asarray`` of one all
either break the capture (a CUDA graph cannot record a synchronizing copy)
or — worse — graph-break and silently sync the stream on every call
(``torch.compile``). These rules find the *traced regions* in a file, the
torch analogue of JAX's traced functions:

* functions decorated with ``torch.compile`` (bare, called, or through
  ``functools.partial``) or passed to ``torch.compile(fn)``, lambdas too;
* the bodies of ``with torch.cuda.graph(...)`` blocks;
* callables passed to ``torch.cuda.make_graphed_callables`` (one, or a
  tuple of them).

They flag host-sync constructs applied to the region's traced values: a
function's parameters, and, for a capture block, the local names of the
function it sits in (module-level constants stay host values).

Attribute chains that stay static — ``x.shape``, ``x.ndim``, ``x.dtype``,
``x.device``, ``x.size()``, ``x.dim()``, ``x.numel()`` — are exempt:
``int(x.shape[0])`` is fine, ``int(x[0])`` is not.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set

from repro_torch.analysis.framework import (
    FileContext,
    Finding,
    resolve_name,
    rule,
)

_COMPILE_NAMES = {"torch.compile"}
_GRAPH_CONTEXTS = {"torch.cuda.graph"}
_GRAPHED_CALLABLES = {"torch.cuda.make_graphed_callables"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "size", "dim", "numel"}
#: tensor methods that copy to the host: method -> rule id
_HOST_METHODS = {
    "item": "host-sync/item",
    "tolist": "host-sync/item",
    "cpu": "host-sync/to-host",
    "numpy": "host-sync/to-host",
}


@dataclasses.dataclass
class Region:
    """One traced region: its root node (a function, lambda or ``with``
    block), how it is traced, the statements it runs and its traced
    names."""

    node: ast.AST
    how: str
    body: List[ast.AST]
    traced: Set[str]

    @property
    def label(self) -> str:
        if isinstance(self.node, ast.With):
            return f"<capture@{self.node.lineno}>"
        return getattr(self.node, "name", "<lambda>")


def _decorator_is_traced(dec: ast.AST, aliases: Dict[str, str]) -> bool:
    if resolve_name(dec, aliases) in _COMPILE_NAMES:
        return True
    if isinstance(dec, ast.Call):
        name = resolve_name(dec.func, aliases)
        if name in _COMPILE_NAMES:
            return True
        if name == "functools.partial" and dec.args:
            return resolve_name(dec.args[0], aliases) in _COMPILE_NAMES
    return False


def _param_names(fn: ast.AST) -> Set[str]:
    args = fn.args
    names = {a.arg for a in args.args + args.posonlyargs + args.kwonlyargs}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    return names


def _local_names(fn: Optional[ast.AST]) -> Set[str]:
    """Parameters and every name bound inside ``fn`` (nothing at module
    level)."""
    if fn is None:
        return set()
    names = _param_names(fn)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names


def _fn_body(fn: ast.AST) -> List[ast.AST]:
    return fn.body if isinstance(fn.body, list) else [fn.body]


def find_traced_regions(ctx: FileContext) -> List[Region]:
    """Every region whose body runs compiled or captured (found once per
    file; the four rules share them)."""
    if "traced_regions" not in ctx.memo:
        ctx.memo["traced_regions"] = _find_traced_regions(ctx)
    return ctx.memo["traced_regions"]


def _find_traced_regions(ctx: FileContext) -> List[Region]:
    defs: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node

    enclosing: Dict[int, ast.AST] = {}  # with-node id -> innermost function

    def visit(node: ast.AST, fn: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.With):
                enclosing[id(child)] = fn  # repro-lint: disable=determinism/id-keyed-cache
            inner = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) else fn
            visit(child, inner)

    regions: List[Region] = []
    seen: Set[int] = set()

    def add_fn(fn_node: ast.AST, how: str) -> None:
        if isinstance(fn_node, (ast.Tuple, ast.List)):
            for elt in fn_node.elts:
                add_fn(elt, how)
            return
        if isinstance(fn_node, ast.Name):
            fn_node = defs.get(fn_node.id)
            if fn_node is None:
                return
        if isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)) and id(fn_node) not in seen:
            seen.add(id(fn_node))  # repro-lint: disable=determinism/id-keyed-cache
            regions.append(Region(fn_node, how, _fn_body(fn_node),
                                  _param_names(fn_node)))

    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _decorator_is_traced(dec, ctx.aliases):
                    add_fn(node, "decorated")
        elif isinstance(node, ast.With):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and \
                        resolve_name(expr.func, ctx.aliases) in _GRAPH_CONTEXTS:
                    if not enclosing:  # the first capture block of the file
                        visit(ctx.tree, None)
                    fn = enclosing.get(id(node))  # repro-lint: disable=determinism/id-keyed-cache
                    traced = _local_names(fn)
                    for stmt in node.body:
                        for sub in ast.walk(stmt):
                            if isinstance(sub, ast.Name) and \
                                    isinstance(sub.ctx, ast.Store):
                                traced.add(sub.id)
                    regions.append(Region(node, "torch.cuda.graph",
                                          node.body, traced))
                    break
        elif isinstance(node, ast.Call):
            name = resolve_name(node.func, ctx.aliases)
            if name is None or not node.args:
                continue
            if name in _COMPILE_NAMES or name in _GRAPHED_CALLABLES:
                add_fn(node.args[0], name.rsplit(".", 1)[-1])
    return regions


def _references_traced(expr: ast.AST, traced: Set[str],
                       aliases: Dict[str, str]) -> bool:
    """Does ``expr`` (an argument subtree) touch a traced value — a traced
    name outside a static ``.shape``-style chain, or a torch call?"""
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(expr):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node  # repro-lint: disable=determinism/id-keyed-cache

    def in_static_chain(node: ast.AST) -> bool:
        cur = node
        while True:
            parent = parents.get(id(cur))  # repro-lint: disable=determinism/id-keyed-cache
            if parent is None:
                return False
            if isinstance(parent, ast.Attribute) and parent.value is cur:
                if parent.attr in _STATIC_ATTRS:
                    return True
                cur = parent
                continue
            if isinstance(parent, ast.Subscript) and parent.value is cur:
                cur = parent
                continue
            return False

    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in traced:
            if not in_static_chain(node):
                return True
        elif isinstance(node, ast.Call):
            name = resolve_name(node.func, aliases)
            if name and name.startswith("torch."):
                return True
    return False


def _body_nodes(region: Region) -> Iterator[ast.AST]:
    for stmt in region.body:
        yield from ast.walk(stmt)


def _host_method_findings(ctx: FileContext, rule_id: str) -> Iterator[Finding]:
    for region in find_traced_regions(ctx):
        for node in _body_nodes(region):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and _HOST_METHODS.get(node.func.attr) == rule_id
                    and not node.args
                    and _references_traced(node.func.value, region.traced,
                                           ctx.aliases)):
                yield ctx.finding(
                    rule_id, node,
                    f"{region.label} (traced via {region.how}): "
                    f".{node.func.attr}() forces a device→host sync; keep the "
                    f"value on the device or move it out of the region",
                )


@rule("host-sync/item",
      ".item()/.tolist() host transfer inside a traced region")
def check_item(ctx: FileContext) -> Iterator[Finding]:
    yield from _host_method_findings(ctx, "host-sync/item")


@rule("host-sync/to-host",
      ".cpu()/.numpy() host copy inside a traced region")
def check_to_host(ctx: FileContext) -> Iterator[Finding]:
    yield from _host_method_findings(ctx, "host-sync/to-host")


@rule("host-sync/host-cast",
      "int()/float()/bool() on a traced value inside a traced region")
def check_host_cast(ctx: FileContext) -> Iterator[Finding]:
    for region in find_traced_regions(ctx):
        for node in _body_nodes(region):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in ("int", "float", "bool")
                    and len(node.args) == 1
                    and _references_traced(node.args[0], region.traced,
                                           ctx.aliases)):
                yield ctx.finding(
                    "host-sync/host-cast", node,
                    f"{region.label} (traced via {region.how}): "
                    f"{node.func.id}() on a device value syncs the stream "
                    f"(a graph break under torch.compile, an error under "
                    f"capture); use tensor casts (x.to) or hoist to the host "
                    f"side",
                )


@rule("host-sync/np-on-tracer",
      "np.asarray/np.array of a traced value inside a traced region")
def check_np_on_tracer(ctx: FileContext) -> Iterator[Finding]:
    for region in find_traced_regions(ctx):
        for node in _body_nodes(region):
            if not isinstance(node, ast.Call):
                continue
            name = resolve_name(node.func, ctx.aliases)
            if name in ("numpy.asarray", "numpy.array", "numpy.ascontiguousarray") \
                    and node.args \
                    and _references_traced(node.args[0], region.traced,
                                           ctx.aliases):
                yield ctx.finding(
                    "host-sync/np-on-tracer", node,
                    f"{region.label} (traced via {region.how}): {name}() "
                    f"copies a device tensor to the host; use torch.as_tensor "
                    f"or keep the array device-resident",
                )
