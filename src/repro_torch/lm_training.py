"""LM training example: a reduced config trained with the full loop
(checkpoints, an injected fault and its recovery, straggler mitigation,
cosine schedule). Twin of the JAX package's ``examples/lm_training.py``;
runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.lm_training [--steps 200] [--moe] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.data.pipeline import LmDataConfig, lm_token_stream
from repro_torch.launch.train import device_batches
from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import TransformerConfig, init_params, loss_fn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.fault import FaultInjector
from repro_torch.train.loop import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--moe", action="store_true", help="deepseek-moe-style reduced config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # Reduced deepseek-moe-16b family config (CPU-sized).
    moe = MoeConfig(n_experts=8, top_k=2, n_shared=1, d_ff=128) if args.moe else None
    cfg = TransformerConfig(
        name="lm-example", n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
        d_ff=512, vocab=512, moe=moe,
    )
    print(f"params: {cfg.param_count()/1e6:.2f}M "
          f"(active {cfg.active_param_count()/1e6:.2f}M)")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    data = device_batches(lm_token_stream(LmDataConfig(vocab=512, seq_len=128, batch=8, seed=0)), dev)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            lambda p, b: loss_fn(cfg, p, b),
            params,
            AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
            TrainerConfig(
                total_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=50, log_every=20,
            ),
            # inject a failure mid-run to demonstrate recovery
            fault_injector=FaultInjector(fail_at_steps=(args.steps // 2,)),
        )
        final = trainer.fit(data)
    print("final metrics:", {k: round(v, 4) for k, v in final.items()})
    losses = [m["loss"] for m in trainer.metrics_log]
    print(f"loss: {losses[0]:.3f} → {losses[-1]:.3f} "
          f"({'decreasing ✓' if losses[-1] < losses[0] else 'NOT decreasing ✗'})")
    print(f"stragglers detected: {trainer.straggler.stragglers_detected}, "
          f"re-dispatches: {trainer.straggler.redispatches}")
    return trainer


if __name__ == "__main__":
    main()
