"""Determinism rule family (twin of ``repro.analysis.determinism``).

Everything the repo measures is contractually replayable bit-for-bit
(snapshots, fingerprints, recovered runs); these rules flag the classic
ways that contract silently breaks:

* ``determinism/wall-clock`` — ``time.time()`` & friends in library
  code. Durations must use ``time.perf_counter()`` (monotonic);
  absolute timestamps make any derived value run-dependent.
* ``determinism/unseeded-rng`` — RNG without an explicit seed, or the
  module-global numpy/stdlib RNG whose stream position depends on
  whatever ran before. In torch the same rule covers the process-global
  generator: seeding it (``torch.manual_seed`` and kin) and drawing from
  it (``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
  ``bernoulli``/``multinomial`` without ``generator=``).
* ``determinism/id-keyed-cache`` — ``id(obj)`` used as a dict/cache
  key: ids are allocation addresses, so cache identity varies run to
  run (and collides after GC).
* ``determinism/unordered-serialization`` — inside serialization paths
  (functions named ``*fingerprint*``, ``*checksum*``, ``to_bytes``,
  ``capture``, ``_pack_log``): iteration over ``.items()`` / ``.keys()``
  / ``.values()`` / sets without ``sorted(...)``, or ``json.dumps``
  without ``sort_keys=True`` — byte output would depend on insertion
  or hash order.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.framework import (
    FileContext,
    Finding,
    resolve_name,
    rule,
)

_WALL_CLOCK = {
    "time.time": "time.perf_counter() for durations / pass timestamps in",
    "time.time_ns": "time.perf_counter_ns() for durations",
    "datetime.datetime.now": "an explicit timestamp argument",
    "datetime.datetime.utcnow": "an explicit timestamp argument",
    "datetime.datetime.today": "an explicit timestamp argument",
    "datetime.date.today": "an explicit timestamp argument",
}

_NP_LEGACY_GLOBAL = {
    "seed", "rand", "randn", "randint", "random", "random_sample",
    "choice", "permutation", "shuffle", "normal", "uniform",
    "standard_normal", "binomial", "multinomial",
}

_STDLIB_RANDOM_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "seed", "getrandbits", "betavariate",
    "expovariate",
}

#: torch's process-global generator: seeding it from library code moves
#: every other caller's stream.
_TORCH_GLOBAL_SEED = {
    "torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
}

#: torch draws that fall back to the process-global generator when no
#: ``generator=`` is passed.
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial",
}

_SERIALIZATION_NAME_PARTS = ("fingerprint", "checksum", "_pack_log")
_SERIALIZATION_NAMES = ("to_bytes", "capture")


@rule("determinism/wall-clock",
      "wall-clock reads (time.time/datetime.now) in library code")
def check_wall_clock(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = resolve_name(node.func, ctx.aliases)
        if name in _WALL_CLOCK:
            yield ctx.finding(
                "determinism/wall-clock", node,
                f"{name}() is wall-clock (run-dependent); use "
                f"{_WALL_CLOCK[name]}",
            )


@rule("determinism/unseeded-rng",
      "unseeded or module-global RNG in library code")
def check_unseeded_rng(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = resolve_name(node.func, ctx.aliases)
        if name is None:
            continue
        if name in ("numpy.random.default_rng", "numpy.random.SeedSequence",
                    "random.Random"):
            if not node.args and not node.keywords:
                yield ctx.finding(
                    "determinism/unseeded-rng", node,
                    f"{name}() without a seed draws OS entropy — pass an "
                    f"explicit seed/SeedSequence",
                )
            continue
        if name.startswith("numpy.random.") and \
                name.rsplit(".", 1)[1] in _NP_LEGACY_GLOBAL:
            yield ctx.finding(
                "determinism/unseeded-rng", node,
                f"{name}() uses the module-global numpy RNG (stream position "
                f"depends on prior calls); use a seeded Generator",
            )
        elif name.startswith("random.") and \
                name.rsplit(".", 1)[1] in _STDLIB_RANDOM_FNS:
            yield ctx.finding(
                "determinism/unseeded-rng", node,
                f"{name}() uses the process-global stdlib RNG; use a seeded "
                f"random.Random or numpy Generator",
            )
        elif name in _TORCH_GLOBAL_SEED:
            yield ctx.finding(
                "determinism/unseeded-rng", node,
                f"{name}() reseeds torch's process-global generator (every "
                f"other caller's stream moves); seed a torch.Generator",
            )
        elif name.startswith("torch.") and name.count(".") == 1 and \
                name.rsplit(".", 1)[1] in _TORCH_DRAWS and \
                not any(kw.arg == "generator" for kw in node.keywords):
            yield ctx.finding(
                "determinism/unseeded-rng", node,
                f"{name}() without generator= draws from torch's "
                f"process-global generator; pass a seeded torch.Generator",
            )


def _id_calls(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                and sub.func.id == "id"):
            yield sub


@rule("determinism/id-keyed-cache",
      "id(obj) used as a dict/cache key")
def check_id_keyed_cache(ctx: FileContext) -> Iterator[Finding]:
    msg = ("id() is an allocation address — run-dependent and reused after "
           "GC; key caches by content fingerprint or a stable handle")
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Subscript):
            for call in _id_calls(node.slice):
                yield ctx.finding("determinism/id-keyed-cache", call, msg)
        elif isinstance(node, ast.Dict):
            for key in node.keys:
                if key is None:
                    continue
                for call in _id_calls(key):
                    yield ctx.finding("determinism/id-keyed-cache", call, msg)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("get", "setdefault", "pop")
                and node.args):
            for call in _id_calls(node.args[0]):
                yield ctx.finding("determinism/id-keyed-cache", call, msg)


def _is_serialization_fn(node: ast.AST) -> bool:
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    name = node.name
    return (name in _SERIALIZATION_NAMES
            or any(part in name for part in _SERIALIZATION_NAME_PARTS))


def _unordered_iter(node: ast.AST) -> str:
    """Non-empty reason string if ``node`` (a loop/comprehension iterable)
    iterates in hash/insertion order."""
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("items", "keys", "values"):
            return f".{node.func.attr}() iterates in dict insertion order"
        if isinstance(node.func, ast.Name) and node.func.id in ("set", "frozenset"):
            return "set iteration order is hash-dependent"
    if isinstance(node, ast.Set):
        return "set iteration order is hash-dependent"
    return ""


@rule("determinism/unordered-serialization",
      "order-dependent iteration / json.dumps without sort_keys in "
      "fingerprint & snapshot serialization paths")
def check_unordered_serialization(ctx: FileContext) -> Iterator[Finding]:
    for fn in ast.walk(ctx.tree):
        if not _is_serialization_fn(fn):
            continue
        for node in ast.walk(fn):
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters.extend(g.iter for g in node.generators)
            for it in iters:
                reason = _unordered_iter(it)
                if reason:
                    yield ctx.finding(
                        "determinism/unordered-serialization", it,
                        f"{fn.name}(): {reason}; wrap in sorted(...) so the "
                        f"serialized bytes are canonical",
                    )
            if isinstance(node, ast.Call):
                name = resolve_name(node.func, ctx.aliases)
                if name == "json.dumps":
                    kw = {k.arg for k in node.keywords}
                    if "sort_keys" not in kw:
                        yield ctx.finding(
                            "determinism/unordered-serialization", node,
                            f"{fn.name}(): json.dumps without sort_keys=True "
                            f"serializes in dict insertion order",
                        )
