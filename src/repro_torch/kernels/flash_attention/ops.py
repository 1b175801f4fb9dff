"""Wrappers of the flash-attention kernel (twin of ``repro.kernels.flash_attention``).

:func:`flash_attention` takes the kernel's batch-head-major layout and
dispatches by the device of ``q``: a CPU tensor goes to the plain version
(:func:`.ref.attention_ref`), a CUDA tensor to the hand-written kernel
``csrc/flash_attention.cu``, which raises if it fails to build or launch.
:func:`mha` takes ``[B, T, H, Dh]`` layouts and hands
:func:`flash_attention` the batch-head-major layout, where q head
``b·Hq + h`` reads kv head ``b·Hkv + h // G``, on either device.

The JAX package's ``use_kernel`` and ``flat_layout`` switches and its TPU
tile sizes ``block_q``/``block_k`` have no twin: the device decides, and
the CUDA kernel picks its own tiles (the tiling changes no result beyond
float rounding, since masked scores contribute exactly 0).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import CudaKernel, check_cuda_tensor
from repro_torch.kernels.flash_attention.ref import attention_ref

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu",
    [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _INT, _I64, ctypes.c_float, _INT, _P],
)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


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
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(t, name, (q.dtype,), 3, q.device)
    bhq, tq, dh = q.shape
    bhkv, tk, dh_k = k.shape
    if tuple(v.shape) != tuple(k.shape) or dh_k != dh:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if bhkv == 0 or bhq % bhkv:
        raise ValueError(f"{bhq} q heads do not split into groups over {bhkv} kv heads")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside the kernel's 1..{MAX_HEAD_DIM}")
    if tk < 1 or q_offset < 0:
        raise ValueError(f"need Tk >= 1 and q_offset >= 0, got {tk} and {q_offset}")
    out = torch.empty_like(q)
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bhq, bhkv, tq, tk, dh, int(causal), q_offset, dh ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
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
