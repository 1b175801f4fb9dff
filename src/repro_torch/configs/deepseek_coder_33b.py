"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch [arXiv:2401.14196; hf]."""

import functools

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="deepseek-coder-33b", n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32_256, dtype=torch.bfloat16, remat=True,
)

base.register(base.ArchConfig(
    arch_id="deepseek-coder-33b",
    family="lm",
    shapes=tuple(base.LM_SHAPES),
    skipped={"long_500k": base.LM_SKIP_LONG},
    dryrun=functools.partial(base.lm_dryrun, FULL),
    smoke=functools.partial(base.lm_smoke, FULL, None),
    meta={"params": FULL.param_count()},
))
