"""Wrappers of the flash-attention kernels (twin of ``repro.kernels.flash_attention``).

:func:`flash_attention` takes the kernel's batch-head-major layout and
dispatches by the device of ``q``: a CPU or ``meta`` tensor goes to the plain version
(:func:`.ref.attention_ref`), a CUDA tensor to a hand-written kernel in
``csrc/flash_attention.cu``, which raises if it fails to build or launch.
:func:`mha` takes ``[B, T, H, Dh]`` layouts and hands
:func:`flash_attention` the batch-head-major layout, where q head
``b·Hq + h`` reads kv head ``b·Hkv + h // G``, on either device.

On the card the route follows the dtype (:func:`plan`): bfloat16 runs the
tensor-core kernel (``"wgmma"``), float32 the float32-pipe kernel
(``"ffma"``; the JAX tests' 2e-5 rules out TF32). The tensor-core kernel
reads head dims of 64 or 128, a whole number of 64-column swizzle boxes;
any other bfloat16 head dim (1..128) is zero-padded to the next of the two
and the output sliced back. That copy is a path for small or odd heads
that no main path takes (granite's heads are 128 wide): zero columns add
exactly 0 to q·k, and the scale stays ``Dh**-0.5`` of the true head dim.
Each launch counts once on :data:`KERNEL` and once under its route.

On the card the kernel's output is differentiable: when autograd records
(grad enabled and an input requiring grad), :func:`flash_attention` runs it
inside a ``torch.autograd.Function`` (:class:`_FlashAttention`) whose
forward is one counted launch that also stores each query row's
log-sum-exp, and whose backward is one counted launch of the hand-written
backward in ``csrc/flash_attention_bwd.cu`` (:data:`BWD_KERNEL`): route
``"wgmma"`` for bfloat16 (head dims padded as the forward's), one
warp-specialised sweep on the tensor cores that keeps dK and dV in
registers and sums dQ across key tiles into a float32 scratch in a fixed
key-tile order, so two calls give the same bits; route ``"ffma"`` for
float32 (FlashAttention-2's two deterministic passes on the float32 pipe).
The JAX package has no Pallas backward (it differentiates its oracle); the
kernel computes that gradient. It raises if it fails to build or launch:
no plain fallback on the card. A call without autograd recording
(serving) launches the forward alone and stores no log-sum-exp. On the CPU
and on ``meta`` the plain forward is differentiated by autograd itself.

The JAX package's ``use_kernel`` and ``flat_layout`` switches and its TPU
tile sizes ``block_q``/``block_k`` have no twin: the device decides, and
the CUDA kernels pick their own tiles (the tiling changes no result beyond
float rounding, since masked scores contribute exactly 0).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import CudaKernel, check_cuda_tensor
from repro_torch.kernels.flash_attention.ref import attention_ref

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu",
    [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _INT, _I64, ctypes.c_float, _INT, _INT, _P],
)
BWD_KERNEL = CudaKernel(
    "flash_attention_bwd", "flash_attention_bwd.cu",
    [_P] * 12 + [_I64, _I64, _I64, _I64, _I64, _I64, _INT, _I64, ctypes.c_float, _INT, _INT, _P],
)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"ffma": 0, "wgmma": 1}
MAX_HEAD_DIM = 128
BOX_COLS = 64  # bf16 columns of one 128-byte swizzle box of the wgmma kernels
BWD_QUERY_TILE = 64  # query rows a step of the wgmma backward; its dQ scratch is kept in whole tiles


def plan(dtype: torch.dtype, dh: int) -> Tuple[str, int]:
    """The kernel route for a CUDA call and the head dim that kernel reads."""
    if dtype == torch.bfloat16:
        return "wgmma", BOX_COLS * -(-dh // BOX_COLS)
    return "ffma", dh


def plan_bwd(dtype: torch.dtype, dh: int) -> Tuple[str, int]:
    """The backward's route for a CUDA call and the head dim it reads: the
    forward's, bfloat16 on the tensor cores (``"wgmma"``) at the padded head
    dim, float32 on the float32 pipe (``"ffma"``) at its own."""
    return plan(dtype, dh)


def flash_attention(
    q: torch.Tensor,  # [B·Hq, Tq, Dh]
    k: torch.Tensor,  # [B·Hkv, Tk, Dh]
    v: torch.Tensor,  # [B·Hkv, Tk, Dh]
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal or non-causal GQA attention; returns q's type and shape."""
    if q.device.type in ("cpu", "meta"):
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu, meta or cuda tensors, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_offset)[0]
    return _kernel_call(q, k, v, causal=causal, q_offset=q_offset)


class _FlashAttention(torch.autograd.Function):
    """The CUDA branch under autograd: forward is the kernel with its
    log-sum-exp (one counted launch of :data:`KERNEL`), backward the
    hand-written backward (one counted launch of :data:`BWD_KERNEL`). The
    log-sum-exp is a second, non-differentiable output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        out, lse = _kernel_call(q, k, v, causal=causal, q_offset=q_offset, with_lse=True)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_kernel_call(q, k, v, out, lse, dout, causal=ctx.causal, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def _check(q, k, v, q_offset) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(t, name, (q.dtype,), 3, q.device)
    bhq, _, dh = q.shape
    bhkv, tk, dh_k = k.shape
    if tuple(v.shape) != tuple(k.shape) or dh_k != dh:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if bhkv == 0 or bhq % bhkv:
        raise ValueError(f"{bhq} q heads do not split into groups over {bhkv} kv heads")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside the kernels' 1..{MAX_HEAD_DIM}")
    if tk < 1 or q_offset < 0:
        raise ValueError(f"need Tk >= 1 and q_offset >= 0, got {tk} and {q_offset}")


def _kernel_call(q, k, v, *, causal: bool, q_offset: int, with_lse: bool = False):
    """The CUDA branch of :func:`flash_attention`: route, head-dim padding,
    one launch through :func:`_launch` (or, ``with_lse``, through
    :func:`_launch_lse`, which also fills the rows' float32 log-sum-exp),
    the output sliced back. Returns ``out``, or ``(out, lse)``."""
    _check(q, k, v, q_offset)
    bhq, tq, dh = q.shape
    route, dh_k = plan(q.dtype, dh)
    if dh_k != dh:
        q, k, v = (F.pad(t, (0, dh_k - dh)) for t in (q, k, v))
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core kernel reads q, k and v by TMA: they must be 16-byte aligned")
    out = torch.empty((bhq, tq, dh_k), dtype=q.dtype, device=q.device)
    if with_lse:
        lse = torch.empty((bhq, tq), dtype=torch.float32, device=q.device)
        _launch_lse(route, q, k, v, out, lse, causal=causal, q_offset=q_offset, scale=dh ** -0.5)
    else:
        _launch(route, q, k, v, out, causal=causal, q_offset=q_offset, scale=dh ** -0.5)
    out = out if dh_k == dh else out[..., :dh].contiguous()
    return (out, lse) if with_lse else out


def _args(route, q, k, v, out, lse, causal: bool, q_offset: int, scale: float) -> tuple:
    """The C entry point's arguments for one launch on ``route`` (``lse``
    None: a null pointer, nothing stored)."""
    bhq, tq, dh = q.shape
    bhkv, tk, _ = k.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            bhq, bhkv, tq, tk, dh, int(causal), q_offset, scale, _DTYPES[q.dtype], _ROUTES[route],
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch(route, q, k, v, out, *, causal: bool, q_offset: int, scale: float) -> None:
    KERNEL.launch(*_args(route, q, k, v, out, None, causal, q_offset, scale), route=route)


def _launch_lse(route, q, k, v, out, lse, *, causal: bool, q_offset: int, scale: float) -> None:
    KERNEL.launch(*_args(route, q, k, v, out, lse, causal, q_offset, scale), route=route)


def _bwd_kernel_call(q, k, v, out, lse, dout, *, causal: bool, q_offset: int):
    """The backward of the CUDA branch: route, head-dim padding (q, k, v,
    out and dout zero-padded as the forward pads; the padded columns of
    every gradient are sliced off), one launch through :func:`_launch_bwd`.
    Returns ``(dq, dk, dv)`` in q's, k's and v's types."""
    dout = dout.contiguous()
    _check(q, k, v, q_offset)
    for name, t in (("out", out), ("dout", dout)):
        check_cuda_tensor(t, name, (q.dtype,), 3, q.device)
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit q {tuple(q.shape)}")
    check_cuda_tensor(lse, "lse", (torch.float32,), 2, q.device)
    if tuple(lse.shape) != tuple(q.shape[:2]):
        raise ValueError(f"lse {tuple(lse.shape)} does not fit q {tuple(q.shape)}")
    dh = q.shape[-1]
    route, dh_k = plan_bwd(q.dtype, dh)
    if dh_k != dh:
        q, k, v, out, dout = (F.pad(t, (0, dh_k - dh)) for t in (q, k, v, out, dout))
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v, out, dout, lse)):
        raise ValueError("the tensor-core backward reads q, k, v, out, dout and lse by TMA: "
                         "they must be 16-byte aligned")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _launch_bwd(route, q, k, v, out, lse, dout, dq, dk, dv, causal=causal, q_offset=q_offset, scale=dh ** -0.5)
    if dh_k != dh:
        dq, dk, dv = (t[..., :dh].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def _launch_bwd(route, q, k, v, out, lse, dout, dq, dk, dv, *, causal: bool, q_offset: int, scale: float) -> None:
    """One counted launch of the backward (its three kernels). Allocates
    Delta's float32 scratch and, on ``"wgmma"``, the zeroed dQ sum
    (``[B·Hq, ceil(Tq/64)·64, Dh]`` float32, freed after the call) and the
    ints of its ordering: a ticket and one semaphore a (q head, query tile).
    There the kernel reads lse and Delta by TMA, whose rows must start on 16
    bytes: at a ``Tq`` that is not a multiple of 4 (decode-like shapes, no
    training path) lse is copied into rows of a padded stride."""
    bhq, tq, dh = q.shape
    bhkv, tk, _ = k.shape
    ld = tq
    dq_acc = order = None
    if route == "wgmma":
        ld = -(-tq // 4) * 4
        if ld != tq:
            lse = F.pad(lse, (0, ld - tq))
        n_qt = -(-tq // BWD_QUERY_TILE)
        dq_acc = torch.zeros((bhq, n_qt * BWD_QUERY_TILE, dh), dtype=torch.float32, device=q.device)
        order = torch.zeros(1 + bhq * n_qt, dtype=torch.int32, device=q.device)
    delta = torch.empty((bhq, ld), dtype=torch.float32, device=q.device)
    BWD_KERNEL.launch(
        *(t.data_ptr() for t in (q, k, v, out, lse, dout, dq, dk, dv, delta)),
        *(None if t is None else t.data_ptr() for t in (dq_acc, order)),
        bhq, bhkv, tq, tk, dh, ld, int(causal), q_offset, scale, _DTYPES[q.dtype], _ROUTES[route],
        torch.cuda.current_stream(q.device).cuda_stream, route=route)


def _ffma_bf16_uncounted(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, q_offset: int = 0,
) -> torch.Tensor:
    """The float32-pipe kernel on bfloat16 CUDA tensors, launched outside the
    counts. No main path calls it: ``chip_smoke.py`` times the previous
    bfloat16 design with it beside the tensor-core kernel."""
    _check(q, k, v, q_offset)
    if q.dtype != torch.bfloat16 or q.device.type != "cuda":
        raise TypeError("_ffma_bf16_uncounted takes bfloat16 CUDA tensors")
    out = torch.empty_like(q)
    KERNEL.call(*_args("ffma", q, k, v, out, None, causal, q_offset, q.shape[-1] ** -0.5))
    return out


def mha(
    q: torch.Tensor,  # [B, Tq, Hq, Dh]
    k: torch.Tensor,  # [B, Tk, Hkv, Dh]
    v: torch.Tensor,  # [B, Tk, Hkv, Dh]
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Multi-head attention over ``[B, T, H, Dh]`` layouts → ``[B, Tq, Hq, Dh]``."""
    b, tq, hq, dh = q.shape
    _, tk, hkv, _ = k.shape
    qf = q.transpose(1, 2).reshape(b * hq, tq, dh).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, tk, dh).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, tk, dh).contiguous()
    of = flash_attention(qf, kf, vf, causal=causal, q_offset=q_offset)
    return of.reshape(b, hq, tq, dh).transpose(1, 2)
