from repro_torch.kernels.embedding_bag.ops import KERNEL, embedding_bag, embedding_bag_auto
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["KERNEL", "embedding_bag", "embedding_bag_auto", "embedding_bag_ref"]
