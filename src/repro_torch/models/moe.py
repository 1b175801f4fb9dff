"""Mixture-of-Experts FFN: shared + routed experts, top-k (twin of ``repro.models.moe``).

Covers the two MoE configs:
* deepseek-moe-16b — 2 shared + 64 routed, top-6, fine-grained d_ff=1408
  [arXiv:2401.06066],
* qwen3-moe-30b-a3b — 128 routed, top-8, d_ff=768.

Dispatch is the JAX package's sort-based grouped dispatch: token→expert
assignments are sorted by expert id (a stable sort, as ``jnp.argsort``),
each expert gets a buffer of ``capacity`` slots (:func:`capacity`;
assignments past it drop, GShard semantics), and the expert SwiGLUs run as
batched products over ``[E, C, d]``. Router: float32 softmax gating, top-k
with ties broken toward the lower expert id (as ``jax.lax.top_k``),
renormalised, and the Switch load-balancing loss (:func:`route`).

Nothing here sums in atomic order, so a call gives the same bits on every
run on the card: the buffer is filled by a plain indexed write (each
``(expert, slot)`` holds at most one token; dropped assignments land in a
spare row that is cut off), and the combine gathers each assignment's
output back to ``[N, k, d]`` and adds the k picks in a fixed order. The
JAX package's ``segment_sum`` computes the same function.

:func:`moe_fwd_ep` is the JAX package's expert-parallel ``moe_fwd_ep``
over a :class:`~repro_torch.launch.mesh.HostMesh` (or the dry run's
:class:`~repro_torch.launch.mesh.MetaMesh`): tokens stay on their data
shard, each model rank holds ``E / model`` experts and routes every token
of its shard, and one ``all_reduce`` over the model axis combines the
experts' outputs with the tensor-parallel shared expert's partials. It is
differentiable in ``x`` and every parameter, with the JAX convention that
every rank holds the global loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import batch_axes, data_shards
from repro_torch.launch.mesh import grad_sum, sum_replicated
from repro_torch.models.layers import normal, swiglu, swiglu_init

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int = 64
    top_k: int = 6
    n_shared: int = 0          # always-on shared experts (DeepSeekMoE)
    d_ff: int = 1408           # per-expert width (fine-grained)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


def moe_init(gen: torch.Generator, d_model: int, cfg: MoeConfig, dtype=torch.float32, device=None) -> Params:
    """Router (always float32), stacked expert weights ``[E, ...]`` and, with
    ``n_shared`` > 0, one shared SwiGLU of width ``d_ff · n_shared``."""
    s = d_model ** -0.5
    e, f = cfg.n_experts, cfg.d_ff
    p: Params = {
        "router": normal((d_model, e), s, gen, torch.float32, device),
        "w_gate": normal((e, d_model, f), s, gen, dtype, device),
        "w_up": normal((e, d_model, f), s, gen, dtype, device),
        "w_down": normal((e, f, d_model), f ** -0.5, gen, dtype, device),
    }
    if cfg.n_shared:
        p["shared"] = swiglu_init(gen, d_model, f * cfg.n_shared, dtype, device)
    return p


def capacity(n_tokens: int, cfg: MoeConfig) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens: at least 8,
    rounded up to a multiple of 8."""
    c = max(int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 8)
    return -(-c // 8) * 8


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row, ties to the lower index.

    ``torch.topk`` promises no order among equal values on either device
    (on the CPU it returns ``[2, 4, 1]`` for the top 3 of ``[.1, .3, .3,
    .2, .3]``, where ``jax.lax.top_k`` returns ``[1, 2, 4]``), so a stable
    descending sort takes its place."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Params, xf: torch.Tensor, cfg: MoeConfig):
    """xf [N, d] → (probs [N, E] float32, gate_vals [N, k] float32,
    expert_idx [N, k] int64, aux scalar float32): softmax router in
    float32, top-k renormalised, and the Switch loss ``E·Σ_e f_e·p_e``
    over the top-1 choices."""
    e = cfg.n_experts
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, cfg.top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)                                      # mean router prob
    ce = F.one_hot(expert_idx[:, 0], e).float().mean(dim=0)     # fraction routed
    aux = cfg.aux_loss_weight * e * torch.sum(me * ce)
    return probs, gate_vals, expert_idx, aux


def _experts(p: Params, xf: torch.Tensor, sort_key: torch.Tensor, gate_vals: torch.Tensor,
             n_experts: int, cap: int, k: int) -> torch.Tensor:
    """Sort-based grouped dispatch of ``xf [N, d]`` into ``n_experts``
    buffers of ``cap`` slots, the stacked SwiGLU experts of ``p``, and the
    combine back to ``[N, d]``. ``sort_key [N·k]`` is each assignment's
    expert (token-major); a key of ``n_experts`` marks an assignment to no
    expert here, which sorts last and drops."""
    n, d = xf.shape
    dev = xf.device
    order = torch.argsort(sort_key, stable=True)
    se = sort_key[order]
    starts = torch.searchsorted(se, torch.arange(n_experts, device=dev, dtype=se.dtype))  # side "left"
    slots = torch.arange(n * k, device=dev) - starts[torch.clamp(se, max=n_experts - 1)]
    keep = (se < n_experts) & (slots < cap)                     # foreign and overflow drop
    row = torch.where(keep, se * cap + slots, n_experts * cap)  # n_experts·cap: the spare row
    buf = torch.zeros((n_experts * cap + 1, d), dtype=xf.dtype, device=dev)
    buf[row] = xf[order // k]                                   # at most one token a kept row
    buf = buf[: n_experts * cap].view(n_experts, cap, d)

    # ---- stacked expert FFN (SwiGLU), E-major batched products
    g = torch.bmm(buf, p["w_gate"])
    h = g * torch.sigmoid(g) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).view(n_experts * cap, d)

    # ---- combine: each assignment's row in token-major order, weighted,
    # then the k picks of a token added in pick order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=dev)
    keep_t = keep[inv]
    expert_out = out_buf[torch.where(keep_t, row[inv], 0)]     # [N*k, D]
    contrib = torch.where(keep_t[:, None], expert_out * gate_vals.reshape(-1, 1).to(xf.dtype), 0.0)
    contrib = contrib.view(n, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def moe_fwd(p: Params, x: torch.Tensor, cfg: MoeConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, D] → (y: [B, T, D], aux_loss scalar)."""
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    _, gate_vals, expert_idx, aux = route(p, xf, cfg)
    y = _experts(p, xf, expert_idx.reshape(-1), gate_vals, cfg.n_experts, capacity(n, cfg), cfg.top_k)
    if cfg.n_shared:
        y = y + swiglu(p["shared"], xf)
    return y.reshape(b, t, d), aux


def moe_fwd_ep(p: Params, x: torch.Tensor, cfg: MoeConfig, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with local dispatch (twin of the JAX
    ``moe_fwd_ep``) on this rank of a mesh with a ``model`` axis and its
    batch axes (``data``, and ``pod`` on a multi-pod mesh).

    ``x [B_loc, T, D]`` is the rank's data shard of the tokens; ``p`` is
    this model rank's shard in the JAX layout (as
    :func:`~repro_torch.distributed.sharding.shard_tree` places it with
    :func:`~repro_torch.distributed.sharding.lm_param_specs`): the whole
    router, its experts ``[e0, e0 + E_loc)`` (``w_gate``/``w_up``/``w_down``
    sliced on E) and, with ``n_shared``, its column shards of the shared
    expert's ``w_gate``/``w_up`` and row shard of its ``w_down`` (tensor
    parallel, as the JAX rules keep it). Every model rank routes all of the
    shard's tokens, with the capacity of the local token count; assignments
    to other ranks' experts sort last and drop here; the rank's experts'
    outputs and its shared-expert partial are summed over the model axis by
    one ``all_reduce``. ``aux`` is the per-shard loss averaged over the
    batch axes, as the JAX ``pmean``. On a (1, 1) mesh the result is
    :func:`moe_fwd`'s, bit for bit, and so are the gradients.

    The backward is Megatron's f/g pair (:func:`~repro_torch.launch.mesh.
    grad_sum`, :func:`~repro_torch.launch.mesh.sum_replicated`): the
    combine and the aux's mean pass their cotangents through, and the
    experts' two inputs (the tokens as dispatched, which the shared expert
    reads too, and the gate values) sum theirs over the model axis. So the
    router's and ``x``'s gradients are whole and equal on every model rank,
    each rank's expert and shared-expert gradients are those of its own
    shards, and a train step sums every leaf's gradient over the batch axes
    only."""
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    e_loc = p["w_gate"].shape[0]
    if e_loc * mesh.shape["model"] != cfg.n_experts:
        raise ValueError(f"{e_loc} local experts on {mesh.shape['model']} model ranks "
                         f"are not the config's {cfg.n_experts}")
    _, gate_vals, expert_idx, aux = route(p, xf, cfg)
    aux = sum_replicated(aux, mesh, batch_axes(mesh)) / data_shards(mesh)

    local_e = expert_idx.reshape(-1) - mesh.axis_index("model") * e_loc
    sort_key = torch.where((local_e >= 0) & (local_e < e_loc), local_e, e_loc)
    xg = grad_sum(xf, mesh, "model")
    y = _experts(p, xg, sort_key, grad_sum(gate_vals, mesh, "model"), e_loc, capacity(n, cfg), cfg.top_k)
    if cfg.n_shared:
        y = y + swiglu(p["shared"], xg)
    y = sum_replicated(y, mesh, "model")
    return y.reshape(b, t, d), aux
