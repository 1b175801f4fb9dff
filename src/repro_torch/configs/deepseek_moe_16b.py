"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE: 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf]."""

import functools

import torch

from repro_torch.configs import base
from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import TransformerConfig

MOE = MoeConfig(n_experts=64, top_k=6, n_shared=2, d_ff=1408)
FULL = TransformerConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102_400, moe=MOE, dtype=torch.bfloat16, remat=True,
)

base.register(base.ArchConfig(
    arch_id="deepseek-moe-16b",
    family="lm",
    shapes=tuple(base.LM_SHAPES),
    skipped={"long_500k": base.LM_SKIP_LONG},
    dryrun=functools.partial(base.lm_dryrun, FULL),
    smoke=functools.partial(base.lm_smoke, FULL, MOE),
    meta={"params": FULL.param_count(), "active_params": FULL.active_param_count()},
))
