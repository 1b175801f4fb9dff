"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Twin of ``repro.launch.train``: trains the JAX launcher's reduced config of
an arch with the full loop (AdamW, cosine schedule, checkpoint and
restart, straggler mitigation), with its data, optimizer and trainer
settings. The LM archs take 4 layers, d_model 128, 8 heads, the arch's
kv-head ratio, d_ff 512, vocab 512, and for an MoE arch
``MoeConfig(min(E, 8), min(k, 2), min(shared, 1), d_ff=128)`` (unlike the
serve launcher, the JAX train launcher keeps ``moe=``); ``din`` trains DIN
on 2,000 items and 50 categories. The parameters are drawn on the CPU from
seed 0 and moved to the device, so a run on the card starts from the same
weights as a run on the CPU. The GNN and MACE archs are not ported yet.
Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch din --steps 50 --ckpt-dir /tmp/din
"""

from __future__ import annotations

import argparse
import importlib
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.launch.serve import ARCHS
from repro_torch.optim.adamw import AdamWConfig, tree_map
from repro_torch.train.fault import FaultInjector
from repro_torch.train.loop import Trainer, TrainerConfig


def _on(tree, dev: torch.device):
    return tree_map(lambda t: t.to(dev), tree)


def device_batches(stream, dev: torch.device):
    """The numpy batches of ``stream`` as tensors on ``dev``."""
    for b in stream:
        yield {k: torch.as_tensor(v, device=dev) for k, v in b.items()}


def train_lm(arch: str, steps: int, ckpt_dir: Optional[str], device=None,
             fault_injector: Optional[FaultInjector] = None) -> Trainer:
    """Train the reduced config of LM ``arch`` for ``steps`` steps; returns
    the trainer (its ``metrics_log``, ``step`` and ``state``)."""
    from repro_torch.data.pipeline import LmDataConfig, lm_token_stream
    from repro_torch.models.moe import MoeConfig
    from repro_torch.models.transformer import TransformerConfig, init_params, loss_fn

    dev = resolve_device(device)
    full = importlib.import_module(ARCHS[arch][1]).FULL
    moe = None
    if full.moe:
        moe = MoeConfig(n_experts=min(full.moe.n_experts, 8), top_k=min(full.moe.top_k, 2),
                        n_shared=min(full.moe.n_shared, 1), d_ff=128)
    cfg = TransformerConfig(
        name=arch + "-reduced", n_layers=4, d_model=128, n_heads=8,
        n_kv_heads=max(1, 8 * full.n_kv_heads // full.n_heads), d_ff=512,
        vocab=512, moe=moe,
    )
    params = _on(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), dev)
    tr = Trainer(
        lambda p, b: loss_fn(cfg, p, b), params,
        AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps),
        TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=max(steps // 4, 1),
                      log_every=max(steps // 10, 1)),
        fault_injector=fault_injector,
    )
    tr.fit(device_batches(lm_token_stream(LmDataConfig(vocab=512, seq_len=128, batch=8)), dev))
    return tr


def train_recsys(arch: str, steps: int, ckpt_dir: Optional[str], device=None,
                 fault_injector: Optional[FaultInjector] = None) -> Trainer:
    """Train DIN on the JAX launcher's synthetic click stream; returns the
    trainer."""
    from repro_torch.data.pipeline import din_stream
    from repro_torch.models import recsys

    dev = resolve_device(device)
    cfg = recsys.DinConfig(n_items=2000, n_cats=50, seq_len=20)
    params = _on(recsys.init(cfg, torch.Generator().manual_seed(0), device="cpu"), dev)
    tr = Trainer(
        lambda p, b: recsys.bce_loss(cfg, p, b), params,
        AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=steps, weight_decay=0.0),
        TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=max(steps // 2, 1),
                      log_every=max(steps // 10, 1)),
        fault_injector=fault_injector,
    )
    tr.fit(device_batches(din_stream(batch=256, seq_len=20, n_items=2000, n_cats=50), dev))
    return tr


RUNNERS = {"lm": train_lm, "recsys": train_recsys}


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.arch not in ARCHS:
        raise NotImplementedError(
            f"--arch {args.arch}: the port trains {sorted(ARCHS)}; the GNN and MACE configs are not "
            "ported yet (ROADMAP, queue A item 12)")
    tr = RUNNERS[ARCHS[args.arch][0]](args.arch, args.steps, args.ckpt_dir, args.device)
    final = {k: v for k, v in tr.metrics_log[-1].items() if k != "step"}
    print(f"[train] {args.arch} done: {final}")
    return tr


if __name__ == "__main__":
    main()
