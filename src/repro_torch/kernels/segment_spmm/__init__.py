from repro_torch.kernels.segment_spmm.ops import (
    KERNEL, CsrMatrix, csr_matrix, segment_spmm, segment_spmm_primary, segment_spmm_secondary, segment_spmm_smooth,
    tile_plan,
)
from repro_torch.kernels.segment_spmm.ref import primary_ref, secondary_ref, segment_spmm_ref, smooth_ref

__all__ = ["KERNEL", "CsrMatrix", "csr_matrix", "primary_ref", "secondary_ref", "segment_spmm",
           "segment_spmm_primary", "segment_spmm_ref", "segment_spmm_secondary", "segment_spmm_smooth",
           "smooth_ref", "tile_plan"]
