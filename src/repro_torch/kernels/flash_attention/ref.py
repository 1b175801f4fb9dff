"""Plain PyTorch version of the flash-attention kernel: causal GQA attention.

``q [B·Hq, Tq, Dh]``, ``k/v [B·Hkv, Tk, Dh]`` with heads laid out
batch-major, so q head ``i`` reads kv head ``i // (Hq/Hkv)``. ``q_offset``
places the queries at positions ``q_offset .. q_offset+Tq-1`` (decode:
``Tq = 1``, ``q_offset = Tk - 1``). Masked scores are ``-inf`` and the
softmax is taken over the whole row, in float32; the result has q's type.
"""

from __future__ import annotations

from typing import Optional

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
    bhq, tq, dh = q.shape
    bhkv, tk, _ = k.shape
    group = bhq // bhkv
    kr = k.repeat_interleave(group, dim=0)
    vr = v.repeat_interleave(group, dim=0)
    if scale is None:
        scale = dh ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr.float()) * scale
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, vr.float()).to(q.dtype)

