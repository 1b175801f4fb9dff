"""Plain PyTorch version of the block-ELL SpMM kernel.

Computes ``Y = A @ X`` where A is given in padded block-ELL layout
(``blocks [nbr, maxnnz, bs, bs]``, ``block_cols [nbr, maxnnz]``,
``block_mask [nbr, maxnnz]``) and X is dense ``[nbr*bs, F]``. Like
``csrc/bell_matmul.cu`` it computes in float32 whatever the input type
and returns X's type.
"""

from __future__ import annotations

import torch


def bell_matmul_ref(
    blocks: torch.Tensor,
    block_cols: torch.Tensor,
    block_mask: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    nbr, maxnnz, bs, _ = blocks.shape
    f = x.shape[1]
    xb = x.reshape(nbr, bs, f).float()
    # The X tile of every (row, slot), zeroed where the slot is padding:
    # [nbr, maxnnz, bs, f]. Masking the small tiles instead of the blocks
    # leaves the blocks uncopied (a float32 input is used as it is).
    gathered = xb[block_cols.long()] * block_mask[:, :, None, None].float()
    out = torch.matmul(blocks.float(), gathered).sum(dim=1)  # [nbr, bs, f]
    return out.reshape(nbr * bs, f).to(x.dtype)
