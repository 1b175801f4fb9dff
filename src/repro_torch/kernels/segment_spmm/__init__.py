from repro_torch.kernels.segment_spmm.ops import KERNEL, CsrMatrix, csr_matrix, segment_spmm
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

__all__ = ["KERNEL", "CsrMatrix", "csr_matrix", "segment_spmm", "segment_spmm_ref"]
