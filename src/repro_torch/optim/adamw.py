"""AdamW over nested dicts of tensors, with clipping and a cosine schedule
(twin of ``repro.optim.adamw``).

Float32 moments whatever the parameter dtype (bf16-safe), global-norm
gradient clipping with the pre-clip norm reported, decoupled weight decay,
a cosine schedule with linear warmup. The state mirrors the parameter tree
(``{"m": tree, "v": tree, "step": int32 0-d tensor}``), so a checkpoint has
the JAX package's keys. The arithmetic follows the JAX package's op for op,
so float32 results agree to rounding.

:func:`update` is pure: it returns new tensors and writes none of its
inputs. The trainer's straggler mitigation may run a step twice, and an
update in place would then apply twice. It walks the tree one leaf at a
time, and a large leaf in slices of its leading axis (at most
``CHUNK_ELEMENTS`` elements a slice), so the float32 temporaries of one
slice are alive at once, not those of the whole tree: the arithmetic is
elementwise, so the slices change no result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

Tree = Dict[str, Any]

#: elements of a leaf updated at once (float32 temporaries of 128 MiB each)
CHUNK_ELEMENTS = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = cfg.lr * torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)

    return lr


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts of the same structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}


def leaves(tree: Tree) -> Iterator[torch.Tensor]:
    """The leaves in the JAX package's order (dict keys sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def tree_unflatten(tree: Tree, values) -> Tree:
    """A tree of ``tree``'s structure whose leaves are ``values`` (an
    iterable) in :func:`leaves` order."""
    return _unflatten(tree, iter(values))


def _unflatten(tree: Tree, it) -> Tree:
    # A module-level function, not a closure: a self-referencing closure
    # would keep ``values`` (a step's gradients) alive until the cyclic
    # garbage collector ran.
    return {k: _unflatten(tree[k], it) if isinstance(tree[k], dict) else next(it) for k in sorted(tree)}


def init(params: Tree) -> Tree:
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(leaves(params)).device
    return {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)))


def update(
    params: Tree,
    grads: Tree,
    state: Tree,
    cfg: AdamWConfig,
    grad_norm: Optional[torch.Tensor] = None,
) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
    """One AdamW step. ``grad_norm`` is the global norm the clipping uses,
    for a rank that holds only a shard of some gradient leaves (the whole
    gradient's norm, which the JAX update computes over global arrays);
    ``None`` computes it from ``grads``."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg)(step)

    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m_, v_):
        g = g.to(torch.float32) * scale
        m_ = b1 * m_ + (1 - b1) * g
        v_ = b2 * v_ + (1 - b2) * g * g
        mh = m_ / bc1
        vh = v_ / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m_, v_

    def upd_sliced(p, g, m_, v_):
        if p.dim() == 0 or p.numel() <= CHUNK_ELEMENTS:
            return upd(p, g, m_, v_)
        rows = max(1, CHUNK_ELEMENTS // (p.numel() // p.shape[0]))
        outs = (torch.empty_like(p), torch.empty_like(m_), torch.empty_like(v_))
        for start in range(0, p.shape[0], rows):
            sl = slice(start, start + rows)
            for o, r in zip(outs, upd(p[sl], g[sl], m_[sl], v_[sl])):
                o[sl] = r
        return outs

    out = tree_map(upd_sliced, params, grads, state["m"], state["v"])
    return _unzip(out, 0), {"m": _unzip(out, 1), "v": _unzip(out, 2), "step": step}, {"lr": lr, "grad_norm": gnorm}


def _unzip(tree: Tree, i: int) -> Tree:
    return {k: _unzip(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}
