"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Twin of ``repro.launch.serve``: the continuous-batching LM engine on a
reduced config of an LM arch (2 layers, d_model 128, 8 heads, the arch's
kv-head ratio, vocab 512), or DIN scoring and retrieval at a reduced size
(10,000 items, 100 categories, history 50), with the same sizes and seeds
as the JAX launcher. Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch din --requests 4096 --device cpu

``--arch graph`` (online graph serving) is not ported yet.
"""

from __future__ import annotations

import argparse
import importlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device

#: arch id → (family, config module) of the archs the port can run.
ARCHS = {
    "granite-3-8b": ("lm", "repro_torch.configs.granite_3_8b"),
    "din": ("recsys", "repro_torch.configs.din"),
}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(arch: str, n_requests: int, device=None) -> float:
    """Serve ``n_requests`` seeded requests; returns tokens per second."""
    from repro_torch.models.transformer import TransformerConfig, init_params
    from repro_torch.serving.engine import Request, ServingEngine

    dev = resolve_device(device)
    full: TransformerConfig = importlib.import_module(ARCHS[arch][1]).FULL
    cfg = TransformerConfig(
        name=arch + "-serve", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=max(1, 8 * full.n_kv_heads // full.n_heads), d_ff=256, vocab=512,
    )
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=128, device=dev)
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(1, 512, size=rng.integers(2, 8)), max_new_tokens=16)
        for _ in range(n_requests)
    ]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in reqs)
    if not all(r.done for r in reqs):
        raise RuntimeError("the engine drained with requests still open")
    print(f"[serve] {arch}: {n_requests} requests, {toks} tokens, "
          f"{toks / dt:.1f} tok/s (continuous batching over 4 slots, {dev.type})")
    return toks / dt


def serve_din(n_requests: int, device=None) -> float:
    """Score ``n_requests`` seeded requests, then one user against 100,000
    candidates; returns requests per second."""
    from repro_torch.data.pipeline import din_batch
    from repro_torch.models import recsys

    dev = resolve_device(device)
    cfg = recsys.DinConfig(n_items=10_000, n_cats=100, seq_len=50)
    params = recsys.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in din_batch(n_requests, 50, 10_000, 100).items()}
    with torch.no_grad():
        recsys.forward(cfg, params, b)  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        logits = recsys.forward(cfg, params, b)
        _sync(dev)
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("DIN scoring gave non-finite logits")
        print(f"[serve] din: scored {n_requests} requests in {dt * 1e3:.1f} ms "
              f"({n_requests / dt:.0f} req/s, {dev.type})")
        uv = recsys.user_vector(cfg, params, b)
        cand = torch.arange(100_000, device=dev) % cfg.n_items
        t0 = time.perf_counter()
        scores = recsys.retrieval_scores(cfg, params, uv[:1], cand, cand % cfg.n_cats)
        _sync(dev)
        print(f"[serve] din retrieval: 1x{scores.shape[1]} candidates in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return n_requests / dt


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.arch == "graph":
        raise NotImplementedError(
            "--arch graph: online graph serving (core/online.py) is not ported yet "
            "(ROADMAP, queue A item 9)")
    if args.arch not in ARCHS:
        raise NotImplementedError(
            f"--arch {args.arch}: the port runs {sorted(ARCHS)}; other configs are not "
            "ported yet (ROADMAP, queue A item 12)")
    if ARCHS[args.arch][0] == "lm":
        serve_lm(args.arch, args.requests, args.device)
    else:
        serve_din(args.requests, args.device)


if __name__ == "__main__":
    main()
