from repro_torch.kernels.flash_attention.ops import KERNEL, flash_attention, mha
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["KERNEL", "attention_ref", "flash_attention", "mha"]
