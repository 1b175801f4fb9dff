"""Decoder-only LM: GQA + RoPE + SwiGLU (+ optional MoE) (twin of ``repro.models.transformer``).

Parameters are stacked over layers like the JAX package's scan pytree:
``embed [V, D]``, ``layers`` (each leaf ``[L, ...]``), ``ln_f``, ``lm_head
[D, V]``. The layer loop is a Python loop over views of the stacked
tensors. :func:`forward` (prefill, scoring and training) runs attention
through the ``flash_attention`` kernel on the card, one launch a layer, and
is differentiable there (the kernel's backward is its plain version);
:func:`serve_step` decodes one token against a ``[L, B, Tmax, Hkv, Dh]``
KV cache, which it updates in place.

:class:`TransformerConfig` keeps the fields that change what is computed,
and ``remat``: with autograd recording, each layer runs under
``torch.utils.checkpoint`` with the JAX policy
(``dots_with_no_batch_dims_saveable``: the weight products are saved,
attention and the element-wise work recomputed in the backward), which
changes memory and time, not the gradients. The JAX package's ``unroll``,
``attn_flat_layout`` and ``use_flash_kernel`` only steer JAX tracing and
kernel dispatch, so they have no twin here (the device decides the kernel).
A config with ``moe`` set runs :func:`~repro_torch.models.moe.moe_fwd` in
place of the dense SwiGLU, in prefill and in decode.

A mesh passed to :func:`forward`, :func:`loss_fn` or :func:`serve_step`
means the JAX package's layout on that
:class:`~repro_torch.launch.mesh.HostMesh`: the tokens are this rank's
data shard and every leaf this rank's shard by
:func:`~repro_torch.distributed.sharding.lm_param_specs`. The embedding
and the cross-entropy are vocabulary parallel, attention and the dense
SwiGLU (and an MoE's shared expert) tensor parallel, the routed experts
expert parallel (:func:`~repro_torch.models.moe.moe_fwd_ep`, the twin of
the JAX ``moe_impl="ep_shardmap"``), and decode is split-K over the cache's
sequence. On a (1, 1) mesh every result is the meshless one, bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch import resolve_device
from repro_torch.distributed.sharding import batch_axes
from repro_torch.launch.mesh import grad_sum, sum_replicated
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
    remat: bool = False                   # recompute each layer in the backward (:func:`_remat_layer`)

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
    expert parallel when a mesh is given) or the dense SwiGLU (aux None;
    tensor parallel on a mesh)."""
    if cfg.moe:
        if mesh is not None:
            return moe_fwd_ep(lp["moe"], L.rmsnorm(lp["ln2"], h), cfg.moe, mesh)
        return moe_fwd(lp["moe"], L.rmsnorm(lp["ln2"], h), cfg.moe)
    return L.swiglu(lp["ffn"], L.rmsnorm(lp["ln2"], h), mesh), None


def _layer_fwd(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
               mesh=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = x + L.attention_fwd(lp["attn"], L.rmsnorm(lp["ln1"], x), cfg.n_heads, cfg.n_kv_heads,
                            rope_theta=cfg.rope_theta, mesh=mesh)
    y, aux = _ffn(cfg, lp, h, mesh)
    return h + y, aux


_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Remat's policy, the JAX ``dots_with_no_batch_dims_saveable``: the
    products with a weight (``mm``; a ``[B, T, D] @ [D, F]`` product is one
    on a view) are saved, everything else (attention, the batched expert
    products, the element-wise work, the collectives) is recomputed."""
    return CheckpointPolicy.MUST_SAVE if op in _WEIGHT_PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_layer(cfg: TransformerConfig, lp: Params, x: torch.Tensor, mesh=None):
    """:func:`_layer_fwd` under ``torch.utils.checkpoint`` with
    :func:`_save_weight_products`: the backward recomputes what the
    policy does not save."""
    return checkpoint(_layer_fwd, cfg, lp, x, mesh, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts, _save_weight_products))


def embed_tokens(params: Params, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """The embedding rows of ``tokens``. With a ``mesh`` the table is this
    model rank's vocabulary rows: tokens outside them read zeros and the
    rows are summed over the model axis."""
    table = params["embed"]
    if mesh is None:
        return table[tokens.long()]
    rows = table.shape[0]
    local = tokens.long() - mesh.axis_index("model") * rows
    inside = (local >= 0) & (local < rows)
    x = torch.where(inside[..., None], table[local.clamp(0, rows - 1)], 0)
    return sum_replicated(x, mesh, "model")


def head(params: Params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``rmsnorm(x) @ lm_head``: the logits, on a ``mesh`` this model rank's
    vocabulary columns of them."""
    x = L.rmsnorm(params["ln_f"], x)
    if mesh is not None:
        x = grad_sum(x, mesh, "model")
    return x @ params["lm_head"]


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] → (logits [B, T, V], aux_loss summed over the layers;
    0 for a dense model).

    With a ``mesh`` (this rank's ``HostMesh``) it runs the JAX layout:
    ``tokens`` is the rank's data shard and ``params`` its shards as
    :func:`~repro_torch.distributed.sharding.shard_tree` places them with
    :func:`~repro_torch.distributed.sharding.lm_param_specs`. The embedding
    is vocabulary parallel, attention and the dense SwiGLU tensor parallel,
    an MoE expert parallel with its shared expert tensor parallel; the
    logits are the shard's tokens and the rank's vocabulary columns, and
    ``aux`` is averaged over the data axis. It is differentiable there as
    on one device. With ``cfg.remat`` and autograd recording, each layer
    runs under :func:`_remat_layer`."""
    x = embed_tokens(params, tokens, mesh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = _remat_layer if cfg.remat and torch.is_grad_enabled() else _layer_fwd
    for i in range(cfg.n_layers):
        x, a = layer(cfg, layer_params(params, i), x, mesh)
        if a is not None:
            aux = aux + a
    return head(params, x, mesh), aux


def token_nll(logits: torch.Tensor, labels: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-token cross-entropy ``log Σ exp(l - m) - (l_label - m)`` in
    float32, ``m`` the row's largest logit. With a ``mesh`` the logits are
    this model rank's vocabulary columns (vocabulary parallel): the max is
    taken over the model axis, and the sum of exponentials and the label's
    logit (read by the rank whose columns hold it) are summed over it."""
    lf = logits.float()
    cols = lf.shape[-1]
    top = lf.detach().amax(dim=-1, keepdim=True)
    local = labels.long()
    if mesh is not None:
        top = mesh.all_reduce(top, op=dist.ReduceOp.MAX, axis="model")
        local = local - mesh.axis_index("model") * cols
    shifted = lf - top
    total = torch.exp(shifted).sum(dim=-1)
    inside = (local >= 0) & (local < cols)
    target = torch.where(inside, torch.gather(shifted, -1, local.clamp(0, cols - 1)[..., None])[..., 0], 0.0)
    if mesh is not None:
        total = sum_replicated(total, mesh, "model")
        target = sum_replicated(target, mesh, "model")
    return torch.log(total) - target


def loss_fn(cfg: TransformerConfig, params: Params, batch: Dict[str, torch.Tensor],
            mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy over ``mask``, plus the MoE aux loss:
    the training loss. On the card its gradient reaches the attention
    weights through ``flash_attention``'s ``torch.autograd.Function``.

    With a ``mesh``, ``batch`` is this rank's data shard, ``params`` its
    shards in the JAX layout (:func:`forward`), the cross-entropy vocabulary
    parallel (:func:`token_nll`) and every rank returns the global loss, as
    the JAX loss under a mesh: the masked sum and the mask's count are
    summed over the batch axes (:func:`~repro_torch.launch.mesh.sum_replicated`).
    Each rank's gradient is then its share of the global one; a train step
    sums the gradients over the batch axes."""
    logits, aux = forward(cfg, params, batch["tokens"], mesh=mesh)
    nll = token_nll(logits, batch["labels"], mesh)
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
    mesh=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step: logits [B, V] and the (updated) cache.

    With a ``mesh``: ``token`` is this rank's data shard, ``params`` its
    shards in the JAX layout, ``cache`` its slice by
    :func:`~repro_torch.distributed.sharding.kv_cache_spec` (its data
    shard's sequences and its model rank's positions); attention is split-K
    over the sequence (:func:`~repro_torch.models.layers.decode_attention`),
    the dense SwiGLU tensor parallel, an MoE expert parallel, and the logits
    are the rank's vocabulary columns."""
    x = embed_tokens(params, token[:, None], mesh)   # [B,1,D]
    ck_all, cv_all = cache
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        attn_out, _ = L.decode_attention(
            lp["attn"], L.rmsnorm(lp["ln1"], x), cfg.n_heads, cfg.n_kv_heads,
            (ck_all[i], cv_all[i]), position, rope_theta=cfg.rope_theta, mesh=mesh,
        )
        h = x + attn_out
        x = h + _ffn(cfg, lp, h, mesh)[0]
    return head(params, x, mesh)[:, 0, :], (ck_all, cv_all)
