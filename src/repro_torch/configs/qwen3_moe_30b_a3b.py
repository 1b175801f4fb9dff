"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""

import functools

import torch

from repro_torch.configs import base
from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import TransformerConfig

MOE = MoeConfig(n_experts=128, top_k=8, n_shared=0, d_ff=768)
FULL = TransformerConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_head=128, d_ff=768, vocab=151_936, moe=MOE, dtype=torch.bfloat16, remat=True,
)

base.register(base.ArchConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="lm",
    shapes=tuple(base.LM_SHAPES),
    skipped={"long_500k": base.LM_SKIP_LONG},
    dryrun=functools.partial(base.lm_dryrun, FULL),
    smoke=functools.partial(base.lm_smoke, FULL, MOE),
    meta={"params": FULL.param_count(), "active_params": FULL.active_param_count()},
))
