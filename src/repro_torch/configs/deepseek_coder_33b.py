"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch [arXiv:2401.14196; hf]."""

import torch

from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="deepseek-coder-33b", n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32_256, dtype=torch.bfloat16,
)
