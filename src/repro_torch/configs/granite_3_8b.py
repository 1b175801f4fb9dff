"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155, GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""

import torch

from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49_155, dtype=torch.bfloat16,
)
