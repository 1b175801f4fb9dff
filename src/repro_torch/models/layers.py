"""Shared layers: RMSNorm, RoPE, GQA attention, SwiGLU, MLP, LayerNorm.

Twin of ``repro.models.layers``. Parameters are plain dictionaries of
tensors with the JAX package's names and orientation (``y = x @ W``), so
weights carry across without transposition. Initialisers draw from an
explicit ``torch.Generator``; they cannot reproduce ``jax.random``'s
numbers, so the parity tests carry the JAX package's weights across
instead (:mod:`repro_torch.convert`).

Attention, decode and SwiGLU take an optional ``mesh`` (a
:class:`~repro_torch.launch.mesh.HostMesh`, or the dry run's
:class:`~repro_torch.launch.mesh.MetaMesh`): their parameters are then
this rank's shards in the JAX layout
(:func:`~repro_torch.distributed.sharding.lm_param_specs`) and they run
Megatron's tensor-parallel products over the model axis, differentiable
through the f/g pair and :func:`~repro_torch.launch.mesh.gather_last`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.flash_attention import mha
from repro_torch.launch.mesh import gather_last, grad_sum, sum_replicated

Params = Dict[str, torch.Tensor]


def normal(shape, scale: float, gen: torch.Generator, dtype, device) -> torch.Tensor:
    """``N(0, 1) · scale`` drawn in float32, then cast (the JAX package's
    ``(normal(key, shape) * s).astype(dtype)``)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------- RMSNorm
def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps)`` with the statistic in float32, cast to
    ``x``'s type before the product."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"]


# ------------------------------------------------------------------- RoPE
def rope_frequencies(d_head: int, theta: float = 10_000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: [B, T, H, Dh]; positions: [T] or [B, T]. Rotates the interleaved
    pairs ``(x[..., 0::2], x[..., 1::2])`` by float32 angles."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, device=x.device)
    if positions.dim() == 1:
        angles = positions[:, None].float() * freqs[None, :]   # [T, Dh/2]
        angles = angles[None, :, None, :]
    else:
        angles = positions[..., None].float() * freqs
        angles = angles[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ------------------------------------------------------------ GQA attention
def attention_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int, d_head: int,
                   dtype=torch.float32, device=None) -> Params:
    s = d_model ** -0.5
    return {
        "wq": normal((d_model, n_heads * d_head), s, gen, dtype, device),
        "wk": normal((d_model, n_kv_heads * d_head), s, gen, dtype, device),
        "wv": normal((d_model, n_kv_heads * d_head), s, gen, dtype, device),
        "wo": normal((n_heads * d_head, d_model), s, gen, dtype, device),
    }


def attention_fwd(
    p: Params,
    x: torch.Tensor,                       # [B, T, D]
    n_heads: int,
    n_kv_heads: int,
    *,
    positions: Optional[torch.Tensor] = None,
    rope_theta: float = 10_000.0,
    mesh=None,
) -> torch.Tensor:
    """Prefill attention, full causal; on the card it runs the
    ``flash_attention`` kernel (one launch a call). With a ``mesh`` it is
    this model rank's share of the tensor-parallel layer
    (:func:`_attention_tp`), the output summed over the model axis."""
    if mesh is not None:
        return _attention_tp(p, x, n_heads, n_kv_heads, positions, rope_theta, mesh)
    b, t, d = x.shape
    d_head = p["wq"].shape[1] // n_heads
    q = (x @ p["wq"]).reshape(b, t, n_heads, d_head)
    k = (x @ p["wk"]).reshape(b, t, n_kv_heads, d_head)
    v = (x @ p["wv"]).reshape(b, t, n_kv_heads, d_head)
    if positions is None:
        positions = torch.arange(t, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = mha(q, k, v, causal=True)
    out = out.reshape(b, t, n_heads * d_head)
    return out @ p["wo"]


def tp_heads(n_heads: int, d_head: int, model: int, rank: int) -> Tuple[int, int, int, int]:
    """Model rank ``rank``'s ``wo`` rows ``[lo, hi)`` (``H·dh / model`` of
    them) and the q heads ``[h0, h1)`` those rows touch."""
    c = n_heads * d_head // model
    lo, hi = rank * c, (rank + 1) * c
    return lo, hi, lo // d_head, -(-hi // d_head)


def kv_for_heads(k: torch.Tensor, h0: int, h1: int, n_heads: int) -> torch.Tensor:
    """The kv heads q heads ``[h0, h1)`` read, from all of ``k`` ``[B, T,
    Hkv, dh]``, as one GQA call takes them: the groups they span when the
    heads lie in one group or fill whole groups, else each q head's kv head
    repeated (a group of one: the heads straddle a group boundary)."""
    g = n_heads // k.shape[2]
    k0, k1 = h0 // g, (h1 - 1) // g + 1
    if k1 - k0 == 1 or (h0 % g == 0 and h1 % g == 0):
        return k[:, :, k0:k1]
    return k[:, :, [h // g for h in range(h0, h1)]]


def _attention_tp(p: Params, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                  positions: Optional[torch.Tensor], rope_theta: float, mesh) -> torch.Tensor:
    """Megatron's attention on model rank r of ``mesh``: ``p`` holds the
    rank's column shards of ``wq``/``wk``/``wv`` and its row shard
    ``[r·c, (r+1)·c)`` of ``wo`` (``c = H·dh / model``), ``x`` is the whole
    (replicated) input. k and v are gathered along the model axis (``Hkv·dh``
    columns). Where the rank's ``wo`` rows are whole heads its q columns are
    exactly those heads; otherwise q is gathered too. The rank runs
    ``flash_attention`` once on the heads its rows touch with the kv heads
    they read (:func:`kv_for_heads`), keeps the columns of its rows, and the
    row-parallel ``wo`` products are summed over the model axis."""
    b, t, _ = x.shape
    model, rank = mesh.shape["model"], mesh.axis_index("model")
    c = p["wo"].shape[0]
    d_head = c * model // n_heads
    lo, hi, h0, h1 = tp_heads(n_heads, d_head, model, rank)
    xin = grad_sum(x, mesh, "model")
    q = xin @ p["wq"]
    if c % d_head:
        q = gather_last(q, mesh, "model")[..., h0 * d_head:h1 * d_head]
    k = gather_last(xin @ p["wk"], mesh, "model").reshape(b, t, n_kv_heads, d_head)
    v = gather_last(xin @ p["wv"], mesh, "model").reshape(b, t, n_kv_heads, d_head)
    q = q.reshape(b, t, h1 - h0, d_head)
    if positions is None:
        positions = torch.arange(t, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = mha(q, kv_for_heads(k, h0, h1, n_heads), kv_for_heads(v, h0, h1, n_heads), causal=True)
    out = out.reshape(b, t, (h1 - h0) * d_head)[..., lo - h0 * d_head:hi - h0 * d_head]
    return sum_replicated(out @ p["wo"], mesh, "model")


def decode_attention(
    p: Params,
    x: torch.Tensor,              # [B, 1, D]
    n_heads: int,
    n_kv_heads: int,
    kv_cache: Tuple[torch.Tensor, torch.Tensor],
    position: int,                # index of the new token
    rope_theta: float = 10_000.0,
    mesh=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a ``[B, Tmax, Hkv, Dh]`` cache.

    Writes the new key and value into the cache in place (the JAX package
    returns updated copies) and returns the same cache tensors. The
    group-factored einsum reads the cache without repeating it and masks
    keys past ``position`` with -1e30 in float32; it never reaches the
    ``flash_attention`` kernel, as in the JAX package. The softmax is taken
    as ``exp(s - max)`` against the value rows, divided by its sum after.

    With a ``mesh`` it is split-K over the sequence: the cache is this model
    rank's positions ``[r·T/model, (r+1)·T/model)`` (``kv_cache_spec``), q,
    k and v are gathered from the column shards (one token), the rank that
    owns ``position`` writes the new key and value, every rank takes its
    positions' partial softmax for all q heads, and the partials are
    combined by log-sum-exp over the model axis before the rank's
    row-parallel ``wo`` (its columns of the heads), summed over the axis.
    """
    b, t, d = x.shape
    if mesh is None:
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    else:
        q, k, v = (gather_last(x @ p[w], mesh, "model") for w in ("wq", "wk", "wv"))
    d_head = q.shape[-1] // n_heads
    q = q.reshape(b, 1, n_heads, d_head)
    k = k.reshape(b, 1, n_kv_heads, d_head)
    v = v.reshape(b, 1, n_kv_heads, d_head)
    pos = torch.full((1,), position, device=x.device)  # filled on the device: no host copy, no sync
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    ck, cv = kv_cache
    tloc = ck.shape[1]
    t0 = 0 if mesh is None else mesh.axis_index("model") * tloc   # the first position this cache holds
    if t0 <= position < t0 + tloc:
        ck[:, position - t0] = k[:, 0].to(ck.dtype)
        cv[:, position - t0] = v[:, 0].to(cv.dtype)
    group = n_heads // n_kv_heads
    qg = q.reshape(b, 1, n_kv_heads, group, d_head).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) * (d_head ** -0.5)
    kpos = torch.arange(t0, t0 + tloc, device=x.device)
    s = s.masked_fill(kpos > position, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    num = torch.einsum("bhgqk,bkhd->bhgqd", e, cv.float())
    if mesh is not None:
        top = mesh.all_reduce(m, op=dist.ReduceOp.MAX, axis="model")
        scale = torch.exp(m - top)
        den = mesh.all_reduce(den * scale, axis="model")
        num = mesh.all_reduce(num * scale, axis="model")
    of = (num / den).permute(0, 3, 1, 2, 4).to(q.dtype)          # [b, 1, h, g, d]
    out = of.reshape(b, 1, n_heads * d_head)
    if mesh is None:
        return out @ p["wo"], (ck, cv)
    lo, hi, _, _ = tp_heads(n_heads, d_head, mesh.shape["model"], mesh.axis_index("model"))
    return sum_replicated(out[..., lo:hi] @ p["wo"], mesh, "model"), (ck, cv)


# ----------------------------------------------------------------- SwiGLU
def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32, device=None) -> Params:
    return {
        "w_gate": normal((d_model, d_ff), d_model ** -0.5, gen, dtype, device),
        "w_up": normal((d_model, d_ff), d_model ** -0.5, gen, dtype, device),
        "w_down": normal((d_ff, d_model), d_ff ** -0.5, gen, dtype, device),
    }


def swiglu(p: Params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``(silu(x·W_gate) · x·W_up)·W_down``. With a ``mesh``, ``p`` holds
    this model rank's column shards of ``w_gate``/``w_up`` and row shard of
    ``w_down`` and the products are summed over the model axis."""
    if mesh is not None:
        return sum_replicated(swiglu(p, grad_sum(x, mesh, "model")), mesh, "model")
    g = x @ p["w_gate"]
    return (g * torch.sigmoid(g) * (x @ p["w_up"])) @ p["w_down"]


# -------------------------------------------------------------- simple MLP
def mlp_init(gen: torch.Generator, dims: Tuple[int, ...], dtype=torch.float32, device=None) -> Params:
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = normal((din, dout), din ** -0.5, gen, dtype, device)
        params[f"b{i}"] = torch.zeros((dout,), dtype=dtype, device=device)
    return params


def mlp(p: Params, x: torch.Tensor, act=torch.relu, final_act: bool = False) -> torch.Tensor:
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------- LayerNorm
def layernorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"] + p["bias"]
