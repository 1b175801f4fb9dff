"""Decoder-only LM: GQA + RoPE + SwiGLU, dense (twin of ``repro.models.transformer``).

Parameters are stacked over layers like the JAX package's scan pytree:
``embed [V, D]``, ``layers`` (each leaf ``[L, ...]``), ``ln_f``, ``lm_head
[D, V]``. The layer loop is a Python loop over views of the stacked
tensors. :func:`forward` (prefill and scoring) runs attention through the
``flash_attention`` kernel on the card, one launch a layer;
:func:`serve_step` decodes one token against a ``[L, B, Tmax, Hkv, Dh]``
KV cache, which it updates in place.

:class:`TransformerConfig` keeps the fields that change what is computed.
The JAX package's ``remat``, ``unroll``, ``moe_impl``, ``attn_flat_layout``
and ``use_flash_kernel`` only steer JAX tracing and kernel dispatch, so they
have no twin here (the device decides the kernel). A config with ``moe`` set
raises ``NotImplementedError``: the MoE layer is not ported yet (ROADMAP,
queue A item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_head: Optional[int] = None          # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    rope_theta: float = 10_000.0
    moe: Optional[Any] = None
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        return self.n_layers * per_layer + self.vocab * d * 2 + d


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP, queue A item 12: moe.py)")


# --------------------------------------------------------------------- init
def init_params(cfg: TransformerConfig, gen: torch.Generator, device=None) -> Params:
    """Random parameters on ``device`` (default CUDA), drawn from ``gen``
    (a generator on that device) one layer at a time into the stacked
    tensors, so the float32 draws never hold more than one layer."""
    _dense_only(cfg)
    dev = resolve_device(device)
    d, n = cfg.d_model, cfg.n_layers
    layers: Params = {}
    for i in range(n):
        lp = {
            "ln1": L.rmsnorm_init(d, cfg.dtype, dev),
            "ln2": L.rmsnorm_init(d, cfg.dtype, dev),
            "attn": L.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype, dev),
            "ffn": L.swiglu_init(gen, d, cfg.d_ff, cfg.dtype, dev),
        }
        for group, leaves in lp.items():
            stacked = layers.setdefault(group, {})
            for name, t in leaves.items():
                if i == 0:
                    stacked[name] = torch.empty((n, *t.shape), dtype=t.dtype, device=dev)
                stacked[name][i] = t
    return {
        "embed": L.normal((cfg.vocab, d), d ** -0.5, gen, cfg.dtype, dev),
        "layers": layers,
        "ln_f": L.rmsnorm_init(d, cfg.dtype, dev),
        "lm_head": L.normal((d, cfg.vocab), d ** -0.5, gen, cfg.dtype, dev),
    }


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return {group: {name: t[i] for name, t in leaves.items()}
            for group, leaves in params["layers"].items()}


# ------------------------------------------------------------------ forward
def _layer_fwd(cfg: TransformerConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    h = x + L.attention_fwd(lp["attn"], L.rmsnorm(lp["ln1"], x), cfg.n_heads, cfg.n_kv_heads,
                            rope_theta=cfg.rope_theta)
    return h + L.swiglu(lp["ffn"], L.rmsnorm(lp["ln2"], h))


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] → (logits [B, T, V], aux_loss); aux is 0 for a dense model."""
    _dense_only(cfg)
    x = params["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        x = _layer_fwd(cfg, layer_params(params, i), x)
    x = L.rmsnorm(params["ln_f"], x)
    logits = x @ params["lm_head"]
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: TransformerConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy over ``mask`` (value only)."""
    logits, aux = forward(cfg, params, batch["tokens"])
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0) + aux


# ------------------------------------------------------------------- decode
def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev))


def serve_step(
    cfg: TransformerConfig,
    params: Params,
    token: torch.Tensor,                          # [B] current token ids
    cache: Tuple[torch.Tensor, torch.Tensor],     # ([L,B,T,Hkv,Dh], ...), updated in place
    position: int,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step: logits [B, V] and the (updated) cache."""
    _dense_only(cfg)
    x = params["embed"][token.long()[:, None]]   # [B,1,D]
    ck_all, cv_all = cache
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        attn_out, _ = L.decode_attention(
            lp["attn"], L.rmsnorm(lp["ln1"], x), cfg.n_heads, cfg.n_kv_heads,
            (ck_all[i], cv_all[i]), position, rope_theta=cfg.rope_theta,
        )
        h = x + attn_out
        x = h + L.swiglu(lp["ffn"], L.rmsnorm(lp["ln2"], h))
    x = L.rmsnorm(params["ln_f"], x)
    logits = (x @ params["lm_head"])[:, 0, :]
    return logits, (ck_all, cv_all)
