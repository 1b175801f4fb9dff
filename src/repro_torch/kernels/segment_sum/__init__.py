from repro_torch.kernels.segment_sum.ops import KERNEL, gather, segment_order, segment_sum
from repro_torch.kernels.segment_sum.ref import segment_order_ref, segment_sum_ref

__all__ = ["KERNEL", "gather", "segment_order", "segment_order_ref", "segment_sum", "segment_sum_ref"]
