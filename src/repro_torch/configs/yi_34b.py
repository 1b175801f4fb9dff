"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
llama-arch GQA [arXiv:2403.04652; hf]."""

import functools

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64_000, dtype=torch.bfloat16, remat=True,
)

base.register(base.ArchConfig(
    arch_id="yi-34b",
    family="lm",
    shapes=tuple(base.LM_SHAPES),
    skipped={"long_500k": base.LM_SKIP_LONG},
    dryrun=functools.partial(base.lm_dryrun, FULL),
    smoke=functools.partial(base.lm_smoke, FULL, None),
    meta={"params": FULL.param_count()},
))
