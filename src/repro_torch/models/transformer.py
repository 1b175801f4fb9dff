"""Decoder-only LM: GQA + RoPE + SwiGLU (+ optional MoE) (twin of ``repro.models.transformer``).

Parameters are stacked over layers like the JAX package's scan pytree:
``embed [V, D]``, ``layers`` (each leaf ``[L, ...]``), ``ln_f``, ``lm_head
[D, V]``. The layer loop is a Python loop over views of the stacked
tensors. :func:`forward` (prefill, scoring and training) runs attention
through the ``flash_attention`` kernel on the card, one launch a layer, and
is differentiable there (the kernel's backward is its plain version);
:func:`serve_step` decodes one token against a ``[L, B, Tmax, Hkv, Dh]``
KV cache, which it updates in place.

:class:`TransformerConfig` keeps the fields that change what is computed.
The JAX package's ``remat``, ``unroll``, ``attn_flat_layout`` and
``use_flash_kernel`` only steer JAX tracing and kernel dispatch, so they
have no twin here (the device decides the kernel). A config with ``moe`` set
runs :func:`~repro_torch.models.moe.moe_fwd` in place of the dense SwiGLU,
in prefill and in decode. The JAX package's ``moe_impl="ep_shardmap"``
is a mesh passed to :func:`forward` or :func:`loss_fn`: it then runs
:func:`~repro_torch.models.moe.moe_fwd_ep` on that
:class:`~repro_torch.launch.mesh.HostMesh`, over this rank's data shard of
the tokens and its parameters as placed by
:func:`~repro_torch.distributed.sharding.shard_tree` with
:func:`~repro_torch.distributed.sharding.ep_param_specs` (the routed
experts split, the rest whole), forward and backward; decode stays dense,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import batch_axes
from repro_torch.launch.mesh import sum_replicated
from repro_torch.models import layers as L
from repro_torch.models.moe import MoeConfig, moe_fwd, moe_fwd_ep, moe_init

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
    moe: Optional[MoeConfig] = None
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def _attn_params(self) -> int:
        d, dh = self.d_model, self.head_dim
        return d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2

    def param_count(self) -> int:
        d = self.d_model
        if self.moe:
            ff = self.moe.n_experts * 3 * d * self.moe.d_ff + d * self.moe.n_experts
            ff += 3 * d * self.moe.d_ff * self.moe.n_shared
        else:
            ff = 3 * d * self.d_ff
        per_layer = self._attn_params() + ff + 2 * d
        return self.n_layers * per_layer + self.vocab * d * 2 + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        ff = (self.moe.top_k + self.moe.n_shared) * 3 * d * self.moe.d_ff
        ff += d * self.moe.n_experts
        per_layer = self._attn_params() + ff + 2 * d
        return self.n_layers * per_layer + self.vocab * d * 2 + d


# --------------------------------------------------------------------- init
def init_params(cfg: TransformerConfig, gen: torch.Generator, device=None) -> Params:
    """Random parameters on ``device`` (default CUDA), drawn from ``gen``
    (a generator on that device) one layer at a time into the stacked
    tensors, so the float32 draws never hold more than one layer."""
    dev = resolve_device(device)
    d, n = cfg.d_model, cfg.n_layers
    layers: Params = {}
    for i in range(n):
        lp = {
            "ln1": L.rmsnorm_init(d, cfg.dtype, dev),
            "ln2": L.rmsnorm_init(d, cfg.dtype, dev),
            "attn": L.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype, dev),
        }
        if cfg.moe:
            lp["moe"] = moe_init(gen, d, cfg.moe, cfg.dtype, dev)
        else:
            lp["ffn"] = L.swiglu_init(gen, d, cfg.d_ff, cfg.dtype, dev)
        _stack_into(layers, lp, i, n)
        del lp  # the last layer's copy goes before the embedding draws
    return {
        "embed": L.normal((cfg.vocab, d), d ** -0.5, gen, cfg.dtype, dev),
        "layers": layers,
        "ln_f": L.rmsnorm_init(d, cfg.dtype, dev),
        "lm_head": L.normal((d, cfg.vocab), d ** -0.5, gen, cfg.dtype, dev),
    }


def init_abstract(cfg: TransformerConfig) -> Params:
    """Shape-only parameters on the ``meta`` device: no storage is allocated
    (twin of the JAX package's ``init_abstract``)."""
    return init_params(cfg, torch.Generator(), device="meta")


def _stack_into(stacked: Params, lp: Params, i: int, n: int) -> None:
    """Copy layer ``i``'s (nested) parameters into the ``[n, ...]`` stacks."""
    for name, t in lp.items():
        if isinstance(t, dict):
            _stack_into(stacked.setdefault(name, {}), t, i, n)
            continue
        if i == 0:
            stacked[name] = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        stacked[name][i] = t


def _index(tree: Params, i: int) -> Params:
    return {name: _index(t, i) if isinstance(t, dict) else t[i] for name, t in tree.items()}


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return _index(params["layers"], i)


# ------------------------------------------------------------------ forward
def _ffn(cfg: TransformerConfig, lp: Params, h: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's feed-forward on ``h``: the MoE (with its aux loss;
    expert parallel when a mesh is given) or the dense SwiGLU (aux None)."""
    if cfg.moe:
        if mesh is not None:
            return moe_fwd_ep(lp["moe"], L.rmsnorm(lp["ln2"], h), cfg.moe, mesh)
        return moe_fwd(lp["moe"], L.rmsnorm(lp["ln2"], h), cfg.moe)
    return L.swiglu(lp["ffn"], L.rmsnorm(lp["ln2"], h)), None


def _layer_fwd(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
               mesh=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = x + L.attention_fwd(lp["attn"], L.rmsnorm(lp["ln1"], x), cfg.n_heads, cfg.n_kv_heads,
                            rope_theta=cfg.rope_theta)
    y, aux = _ffn(cfg, lp, h, mesh)
    return h + y, aux


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] → (logits [B, T, V], aux_loss summed over the layers;
    0 for a dense model).

    With a ``mesh`` (this rank's ``HostMesh``) the MoE runs expert
    parallel: ``tokens`` is the rank's data shard and ``params`` its
    placement by ``ep_param_specs``; the logits are the shard's and ``aux``
    is averaged over the data axis. It is differentiable there as on one
    device (:func:`~repro_torch.models.moe.moe_fwd_ep`)."""
    if mesh is not None and not cfg.moe:
        raise ValueError("an expert-parallel forward (a mesh) needs an MoE config")
    x = params["embed"][tokens.long()]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = _layer_fwd(cfg, layer_params(params, i), x, mesh)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(params["ln_f"], x)
    logits = x @ params["lm_head"]
    return logits, aux


def loss_fn(cfg: TransformerConfig, params: Params, batch: Dict[str, torch.Tensor],
            mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy over ``mask``, plus the MoE aux loss:
    the training loss. On the card its gradient reaches the attention
    weights through ``flash_attention``'s ``torch.autograd.Function``.

    With a ``mesh``, ``batch`` is this rank's data shard and every rank
    returns the global loss, as the JAX loss under a mesh: the masked sum
    and the mask's count are summed over the batch axes
    (:func:`~repro_torch.launch.mesh.sum_replicated`), and an MoE config
    runs expert parallel (:func:`forward` with the mesh). Each rank's
    gradient is then its share of the global one; a train step sums the
    gradients over the batch axes. A dense config runs data parallel."""
    logits, aux = forward(cfg, params, batch["tokens"], mesh=mesh if cfg.moe else None)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    total, count = (nll * mask).sum(), mask.sum()
    if mesh is not None:
        both = sum_replicated(torch.stack([total, count]), mesh, batch_axes(mesh))
        total, count = both[0], both[1]
    return total / torch.clamp(count, min=1.0) + aux


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
    x = params["embed"][token.long()[:, None]]   # [B,1,D]
    ck_all, cv_all = cache
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        attn_out, _ = L.decode_attention(
            lp["attn"], L.rmsnorm(lp["ln1"], x), cfg.n_heads, cfg.n_kv_heads,
            (ck_all[i], cv_all[i]), position, rope_theta=cfg.rope_theta,
        )
        h = x + attn_out
        x = h + _ffn(cfg, lp, h)[0]
    x = L.rmsnorm(params["ln_f"], x)
    logits = (x @ params["lm_head"])[:, 0, :]
    return logits, (ck_all, cv_all)
