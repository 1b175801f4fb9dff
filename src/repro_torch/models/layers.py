"""Shared layers: RMSNorm, RoPE, GQA attention, SwiGLU, MLP, LayerNorm.

Twin of ``repro.models.layers``. Parameters are plain dictionaries of
tensors with the JAX package's names and orientation (``y = x @ W``), so
weights carry across without transposition. Initialisers draw from an
explicit ``torch.Generator``; they cannot reproduce ``jax.random``'s
numbers, so the parity tests carry the JAX package's weights across
instead (:mod:`repro_torch.convert`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import mha

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
) -> torch.Tensor:
    """Prefill attention, full causal; on the card it runs the
    ``flash_attention`` kernel (one launch a call)."""
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


def decode_attention(
    p: Params,
    x: torch.Tensor,              # [B, 1, D]
    n_heads: int,
    n_kv_heads: int,
    kv_cache: Tuple[torch.Tensor, torch.Tensor],
    position: int,                # index of the new token
    rope_theta: float = 10_000.0,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a ``[B, Tmax, Hkv, Dh]`` cache.

    Writes the new key and value into the cache in place (the JAX package
    returns updated copies) and returns the same cache tensors. The
    group-factored einsum reads the cache without repeating it and masks
    keys past ``position`` with -1e30 in float32; it never reaches the
    ``flash_attention`` kernel, as in the JAX package.
    """
    b, t, d = x.shape
    d_head = p["wq"].shape[1] // n_heads
    q = (x @ p["wq"]).reshape(b, 1, n_heads, d_head)
    k = (x @ p["wk"]).reshape(b, 1, n_kv_heads, d_head)
    v = (x @ p["wv"]).reshape(b, 1, n_kv_heads, d_head)
    pos = torch.full((1,), position, device=x.device)  # filled on the device: no host copy, no sync
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    ck, cv = kv_cache
    ck[:, position] = k[:, 0].to(ck.dtype)
    cv[:, position] = v[:, 0].to(cv.dtype)
    tmax = ck.shape[1]
    group = n_heads // n_kv_heads
    qg = q.reshape(b, 1, n_kv_heads, group, d_head).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) * (d_head ** -0.5)
    kpos = torch.arange(tmax, device=x.device)
    s = s.masked_fill(kpos > position, -1e30)
    p_ = torch.softmax(s, dim=-1)
    of = torch.einsum("bhgqk,bkhd->bqhgd", p_, cv.float()).to(q.dtype)
    out = of.reshape(b, 1, n_heads * d_head)
    return out @ p["wo"], (ck, cv)


# ----------------------------------------------------------------- SwiGLU
def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32, device=None) -> Params:
    return {
        "w_gate": normal((d_model, d_ff), d_model ** -0.5, gen, dtype, device),
        "w_up": normal((d_model, d_ff), d_model ** -0.5, gen, dtype, device),
        "w_down": normal((d_ff, d_model), d_ff ** -0.5, gen, dtype, device),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
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
