from repro_torch.kernels.bsr_spmm.ops import KERNEL, bell_matmul, make_bell_matmul
from repro_torch.kernels.bsr_spmm.ref import bell_matmul_ref

__all__ = ["KERNEL", "bell_matmul", "bell_matmul_ref", "make_bell_matmul"]
