from repro_torch.kernels.flash_attention.ops import BWD_KERNEL, KERNEL, flash_attention, mha
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["BWD_KERNEL", "KERNEL", "attention_ref", "flash_attention", "mha"]
