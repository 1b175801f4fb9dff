"""Wrappers of the flash-attention kernels (twin of ``repro.kernels.flash_attention``).

:func:`flash_attention` takes the kernel's batch-head-major layout and
dispatches by the device of ``q``: a CPU tensor goes to the plain version
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
    [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _INT, _I64, ctypes.c_float, _INT, _INT, _P],
)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"ffma": 0, "wgmma": 1}
MAX_HEAD_DIM = 128
BOX_COLS = 64  # bf16 columns of one 128-byte swizzle box of the wgmma kernel


def plan(dtype: torch.dtype, dh: int) -> Tuple[str, int]:
    """The kernel route for a CUDA call and the head dim that kernel reads."""
    if dtype == torch.bfloat16:
        return "wgmma", BOX_COLS * -(-dh // BOX_COLS)
    return "ffma", dh


def flash_attention(
    q: torch.Tensor,  # [B·Hq, Tq, Dh]
    k: torch.Tensor,  # [B·Hkv, Tk, Dh]
    v: torch.Tensor,  # [B·Hkv, Tk, Dh]
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal or non-causal GQA attention; returns q's type and shape."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    return _kernel_call(q, k, v, causal=causal, q_offset=q_offset)


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


def _kernel_call(q, k, v, *, causal: bool, q_offset: int) -> torch.Tensor:
    """The CUDA branch of :func:`flash_attention`: route, head-dim padding,
    one launch through :func:`_launch`, the output sliced back."""
    _check(q, k, v, q_offset)
    bhq, tq, dh = q.shape
    route, dh_k = plan(q.dtype, dh)
    if dh_k != dh:
        q, k, v = (F.pad(t, (0, dh_k - dh)) for t in (q, k, v))
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core kernel reads q, k and v by TMA: they must be 16-byte aligned")
    out = torch.empty((bhq, tq, dh_k), dtype=q.dtype, device=q.device)
    _launch(route, q, k, v, out, causal=causal, q_offset=q_offset, scale=dh ** -0.5)
    return out if dh_k == dh else out[..., :dh].contiguous()


def _args(route, q, k, v, out, causal: bool, q_offset: int, scale: float) -> tuple:
    """The C entry point's arguments for one launch on ``route``."""
    bhq, tq, dh = q.shape
    bhkv, tk, _ = k.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bhq, bhkv, tq, tk, dh,
            int(causal), q_offset, scale, _DTYPES[q.dtype], _ROUTES[route],
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch(route, q, k, v, out, *, causal: bool, q_offset: int, scale: float) -> None:
    KERNEL.launch(*_args(route, q, k, v, out, causal, q_offset, scale), route=route)


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
    KERNEL.call(*_args("ffma", q, k, v, out, causal, q_offset, q.shape[-1] ** -0.5))
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
