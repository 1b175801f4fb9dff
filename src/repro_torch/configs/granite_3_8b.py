"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155, GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""

import functools

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49_155, dtype=torch.bfloat16, remat=True,
)

base.register(base.ArchConfig(
    arch_id="granite-3-8b",
    family="lm",
    shapes=tuple(base.LM_SHAPES),
    skipped={"long_500k": base.LM_SKIP_LONG},
    dryrun=functools.partial(base.lm_dryrun, FULL),
    smoke=functools.partial(base.lm_smoke, FULL, None),
    meta={"params": FULL.param_count()},
))
