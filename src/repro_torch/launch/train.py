"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Twin of ``repro.launch.train``: trains the JAX launcher's reduced config of
an arch with the full loop (AdamW, cosine schedule, checkpoint and
restart, straggler mitigation), with its data, optimizer and trainer
settings. The LM archs take 4 layers, d_model 128, 8 heads, the arch's
kv-head ratio, d_ff 512, vocab 512, and for an MoE arch
``MoeConfig(min(E, 8), min(k, 2), min(shared, 1), d_ff=128)`` (unlike the
serve launcher, the JAX train launcher keeps ``moe=``); ``din`` trains DIN
on 2,000 items and 50 categories. The GNN archs train width 32 (d_in 32,
4 classes; MeshGraphNet 4 blocks, 3 edge features, its loss the mean
square of its output) on ``cora_like`` (``gis`` for MeshGraphNet) at
``scale=0.01``, with labels from a DiDiC partition (k=4, 30 iterations)
modulo 4; ``mace`` (width 32, 2 layers) fits seeded random energies of
``molecules`` at ``scale=0.1``; lr 5e-3, 5 warmup steps, no weight
decay. The parameters (and the DiDiC labels) are made on the CPU from
fixed seeds and moved to the device, so a run on the card starts from the
same weights and data as a run on the CPU. Runs on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch din --steps 50 --ckpt-dir /tmp/din
    PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora --steps 100 --device cpu
"""

from __future__ import annotations

import argparse
import importlib
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
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


GNN_KINDS = {"gcn-cora": "gcn", "graphsage-reddit": "sage", "meshgraphnet": "meshgraphnet"}


def _gnn_graph(arch: str):
    from repro_torch.graphs import datasets

    return datasets.load("gis" if arch == "meshgraphnet" else "cora_like", scale=0.01)


def gnn_parts(arch: str) -> np.ndarray:
    """The DiDiC partition behind a GNN arch's labels (k=4, 30 iterations,
    on the CPU), as :func:`gnn_task` draws it when given none."""
    from repro_torch.core.didic import DidicConfig, didic_partition

    parts, _ = didic_partition(_gnn_graph(arch), DidicConfig(k=4, iterations=30), seed=0, device="cpu")
    return parts


def gnn_task(arch: str, device=None, parts: Optional[np.ndarray] = None) -> Tuple[object, Dict, Dict]:
    """``(cfg, params, batch)`` of the JAX launcher's task for a GNN arch or
    ``mace``, on ``device``; ``batch`` holds the whole graph's tensors, the
    same every step. ``parts`` replaces the DiDiC partition behind the GNN
    labels; without it DiDiC runs on the CPU, whose draws do not depend on
    where the model trains."""
    from repro_torch.data.pipeline import gnn_features
    from repro_torch.graphs import datasets
    from repro_torch.models import gnn, mace

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    if arch == "mace":
        mol = datasets.load("molecules", scale=0.1)
        cfg = mace.MaceConfig(d_hidden=32, n_layers=2)
        params = mace.init(cfg, gen, device="cpu")
        n_mols = int(mol.node_attrs["mol_id"].max()) + 1
        batch = {k: mol.node_attrs[k] for k in ("species", "pos", "mol_id")}
        batch.update(senders=mol.senders, receivers=mol.receivers,
                     target=np.random.default_rng(0).normal(size=n_mols).astype(np.float32))
    else:
        g = _gnn_graph(arch)
        if parts is None:
            parts = gnn_parts(arch)
        x, labels = gnn_features(g.n_nodes, 32, 4, parts_hint=parts)
        s, r, _ = g.undirected
        kind = GNN_KINDS[arch]
        cfg = gnn.GnnConfig(kind=kind, n_layers=2 if kind != "meshgraphnet" else 4,
                            d_in=32, d_hidden=32, d_out=4, d_edge_in=3)
        params = gnn.init(cfg, gen, device="cpu")
        batch = {"x": x, "labels": labels, "senders": s, "receivers": r}
        if kind == "meshgraphnet":
            batch["edge_feat"] = torch.randn((s.shape[0], 3), generator=torch.Generator().manual_seed(3))
    return cfg, _on(params, dev), {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def sage_sampled_batch(blocks, x: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A two-hop sampled GraphSAGE batch on the device of ``x`` and
    ``labels`` (every node's), keyed as the JAX package's ``minibatch_lg``
    cell: the outer block's source features, gathered where ``x`` lies,
    each block's neighbours and mask, the batch nodes' labels."""
    outer, inner = blocks
    dev = x.device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             (("nbrs0", outer.neighbors), ("mask0", outer.mask), ("nbrs1", inner.neighbors), ("mask1", inner.mask))}
    batch["feats"] = x[torch.as_tensor(outer.src_nodes, device=dev)]
    batch["labels"] = labels[torch.as_tensor(inner.src_nodes[:inner.n_targets], device=dev)]
    return batch


def gnn_loss(cfg, p, b: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The JAX launcher's loss: node classification for GCN and GraphSAGE
    (full graph, or a :func:`sage_sampled_batch`), the mean square of
    MeshGraphNet's output, MACE's mean squared energy error."""
    from repro_torch.models import gnn, mace

    if isinstance(cfg, mace.MaceConfig):
        e, _ = mace.forward(cfg, p, b["species"], b["pos"], b["senders"], b["receivers"], b["mol_id"],
                            b["target"].shape[0])
        return torch.mean((e - b["target"]) ** 2)
    if cfg.kind == "meshgraphnet":
        return torch.mean(gnn.mgn_forward(cfg, p, b["x"], b["edge_feat"], b["senders"], b["receivers"]) ** 2)
    if "nbrs0" in b:
        out = gnn.sage_forward_sampled(cfg, p, [b["feats"]], [b["nbrs0"], b["nbrs1"]], [b["mask0"], b["mask1"]],
                                       [b["nbrs0"].shape[0], b["nbrs1"].shape[0]])
    elif cfg.kind == "gcn":
        out = gnn.gcn_forward(cfg, p, b["x"], b["senders"], b["receivers"])
    else:
        out = gnn.sage_forward_full(cfg, p, b["x"], b["senders"], b["receivers"])
    return gnn.node_classification_loss(out, b["labels"])


def train_gnn(arch: str, steps: int, ckpt_dir: Optional[str], device=None,
              fault_injector: Optional[FaultInjector] = None,
              parts: Optional[np.ndarray] = None) -> Trainer:
    """Train the JAX launcher's task of GNN arch or ``mace`` (:func:`gnn_task`,
    ``parts`` as there) for ``steps`` steps; returns the trainer."""
    cfg, params, batch = gnn_task(arch, device, parts=parts)
    tr = Trainer(
        lambda p, b: gnn_loss(cfg, p, b), params,
        AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=steps, weight_decay=0.0),
        TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=max(steps // 2, 1),
                      log_every=max(steps // 10, 1)),
        fault_injector=fault_injector,
    )
    tr.fit(itertools.repeat(batch))
    return tr


RUNNERS = {"lm": train_lm, "gnn": train_gnn, "recsys": train_recsys}


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.arch not in ARCHS:
        raise KeyError(f"unknown arch {args.arch!r}; have {sorted(ARCHS)}")
    tr = RUNNERS[ARCHS[args.arch][0]](args.arch, args.steps, args.ckpt_dir, args.device)
    final = {k: v for k, v in tr.metrics_log[-1].items() if k != "step"}
    print(f"[train] {args.arch} done: {final}")
    return tr


if __name__ == "__main__":
    main()
