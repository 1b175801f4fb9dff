"""Plain PyTorch version of the flash-attention kernel: causal GQA attention.

``q [B·Hq, Tq, Dh]``, ``k/v [B·Hkv, Tk, Dh]`` with heads laid out
batch-major, so q head ``i`` reads kv head ``i // (Hq/Hkv)``. ``q_offset``
places the queries at positions ``q_offset .. q_offset+Tq-1`` (decode:
``Tq = 1``, ``q_offset = Tk - 1``). Masked scores are ``-inf`` and the
softmax is taken over the whole row, in float32; the result has q's type.

:func:`attention_lse_ref` also returns each row's log-sum-exp, as the
kernel's forward stores it for the backward, and
:func:`attention_bwd_lse_ref` is the backward from that saved output and
log-sum-exp, the function the hand-written backward
(``csrc/flash_attention_bwd.cu``) computes; the tests and ``chip_smoke.py``
hold the kernels to them. :func:`attention_bwd_ref` is the closed-form
backward from q, k and v alone, held to ``jax.grad``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# (B, Hq, Hkv, Tq, Tk, Dh, causal, q_offset) of the JAX package's kernel
# tests (tests/test_kernels.py, TestFlashAttention): the port's tests and
# chip_smoke.py hold the kernel to this plain version at these shapes.
TEST_SHAPES = (
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 8, 8, 128, 128, 64, True, 0),
    (2, 4, 1, 1, 96, 32, True, 95),     # decode shape
    (1, 2, 2, 80, 80, 16, False, 0),    # unaligned non-causal
    (1, 4, 4, 50, 50, 64, True, 0),     # unaligned causal
)


def _scores(q, k, causal: bool, q_offset: int, scale: Optional[float]) -> torch.Tensor:
    """The scaled, masked float32 scores ``[B·Hq, Tq, Tk]`` (masked ``-inf``)."""
    bhq, tq, dh = q.shape
    bhkv, tk, _ = k.shape
    kr = k.repeat_interleave(bhq // bhkv, dim=0)
    if scale is None:
        scale = dh ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr.float()) * scale
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    return s


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``scale`` multiplies q·k; ``None`` means ``Dh**-0.5``."""
    s = _scores(q, k, causal, q_offset, scale)
    vr = v.repeat_interleave(q.shape[0] // k.shape[0], dim=0)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, vr.float()).to(q.dtype)


def attention_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_ref`'s output and each query row's log-sum-exp of
    its scaled, masked scores (float32 ``[B·Hq, Tq]``, natural log), what
    the kernel's forward stores for its backward."""
    s = _scores(q, k, causal, q_offset, scale)
    return attention_ref(q, k, v, causal=causal, q_offset=q_offset, scale=scale), torch.logsumexp(s, dim=-1)


def attention_bwd_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward from the forward's saved output ``o`` and log-sum-exp
    ``lse``, as the hand-written backward computes it: ``P = exp(S·scale −
    lse)`` (masked entries exactly 0), ``Δ = rowsum(dO∘o)`` from the saved
    ``o``, ``dV = Pᵀ·dO``, ``dS = P∘(dO·Vᵀ − Δ)``, ``dQ = dS·K·scale``,
    ``dK = dSᵀ·Q·scale``, a kv head's ``dK`` and ``dV`` summed over its
    q heads; float32 throughout, returned in q's, k's and v's types."""
    bhq, tq, dh = q.shape
    bhkv, tk, _ = k.shape
    group = bhq // bhkv
    if scale is None:
        scale = dh ** -0.5
    qf, do = q.float(), dout.float()
    kr = k.float().repeat_interleave(group, dim=0)
    vr = v.float().repeat_interleave(group, dim=0)
    p = torch.exp(_scores(q, k, causal, q_offset, scale) - lse.float()[..., None])
    delta = (do * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.bmm(p.transpose(1, 2), do)
    ds = torch.bmm(do, vr.transpose(1, 2)).sub_(delta).mul_(p)
    del p
    dq = torch.bmm(ds, kr).mul_(scale)
    dk = torch.bmm(ds.transpose(1, 2), qf).mul_(scale)
    if group > 1:
        dk = dk.reshape(bhkv, group, tk, dh).sum(dim=1)
        dv = dv.reshape(bhkv, group, tk, dh).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of :func:`attention_ref` (scale
    ``Dh**-0.5``) for the output gradient ``dout``, in q's, k's and v's types.

    Closed form, in float32: it recomputes ``P`` and ``O = P·V``, then
    ``dV = Pᵀ·dO``, ``dP = dO·Vᵀ``, ``dS = P∘(dP − rowsum(dO∘O))``,
    ``dQ = dS·K·scale``, ``dK = dSᵀ·Q·scale``. ``P`` and ``dP`` are the two
    ``[B·Hq, Tq, Tk]`` tensors it holds at once (``dS`` overwrites ``dP``).
    A kv head's ``dK`` and ``dV`` are the sums over the ``Hq/Hkv`` q heads
    that read it."""
    bhq, tq, dh = q.shape
    bhkv, tk, _ = k.shape
    group = bhq // bhkv
    scale = dh ** -0.5
    qf, do = q.float(), dout.float()
    kr = k.float().repeat_interleave(group, dim=0)
    vr = v.float().repeat_interleave(group, dim=0)
    p = torch.bmm(qf, kr.transpose(1, 2)).mul_(scale)
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(tk, device=q.device)[None, :]
        p.masked_fill_(kpos > qpos, float("-inf"))
    p.sub_(p.amax(dim=-1, keepdim=True)).exp_()
    p.div_(p.sum(dim=-1, keepdim=True))
    delta = (do * torch.bmm(p, vr)).sum(dim=-1, keepdim=True)    # rowsum(dO∘O)
    dv = torch.bmm(p.transpose(1, 2), do)
    ds = torch.bmm(do, vr.transpose(1, 2)).sub_(delta).mul_(p)   # dP, then dS in place
    del p
    dq = torch.bmm(ds, kr).mul_(scale)
    dk = torch.bmm(ds.transpose(1, 2), qf).mul_(scale)
    if group > 1:
        dk = dk.reshape(bhkv, group, tk, dh).sum(dim=1)
        dv = dv.reshape(bhkv, group, tk, dh).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
