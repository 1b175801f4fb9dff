"""Port parity for LM serving: the continuous-batching engine and the
``repro_torch.launch.serve`` entry point, on the CPU.

The port's engine must give the same tokens as the JAX package's engine,
including its two quirks (prefill writes each prompt token into every
slot; a decode step runs all slots at one shared clock). Weights are drawn
by the JAX package and carried across as numpy; greedy tokens must be
identical and the final KV caches within 1e-4.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jax_tf
from repro.models.moe import MoeConfig as JaxMoeConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
import repro_torch
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.moe import MoeConfig
from repro_torch.serving.engine import Request, ServingEngine

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128)


def _requests(cls, seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(1, 128, size=rng.integers(2, 8)), max_new_tokens=int(rng.integers(3, 9)))
            for _ in range(n)]


def _engine_parity(jcfg, cfg):
    jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(1))
    params = convert.transformer_params_from_arrays(jax.tree.map(np.asarray, jparams), device="cpu")
    jeng = JaxEngine(jcfg, jparams, batch_slots=2, max_len=32)
    eng = ServingEngine(cfg, params, batch_slots=2, max_len=32, device="cpu")
    jreqs, reqs = _requests(JaxRequest), _requests(Request)
    for a, b in zip(jreqs, reqs):
        jeng.submit(a)
        eng.submit(b)
    jeng.run_until_drained()
    eng.run_until_drained()
    assert all(r.done for r in reqs) and all(r.done for r in jreqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [len(r.generated) for r in reqs] == [r.max_new_tokens for r in reqs]
    for got, want in zip(eng.cache, jeng.cache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_engine_tokens_identical_to_jax_engine():
    _engine_parity(jax_tf.TransformerConfig(**LM), tf.TransformerConfig(**LM))


def test_moe_engine_tokens_identical_to_jax_engine():
    """The engine over an MoE LM (shared and routed experts; a decode step
    routes its 2 slots, with 8 slots of capacity for each expert)."""
    moe = dict(n_experts=8, top_k=2, n_shared=1, d_ff=32)
    _engine_parity(jax_tf.TransformerConfig(**LM, moe=JaxMoeConfig(**moe)),
                   tf.TransformerConfig(**LM, moe=MoeConfig(**moe)))


def test_prefill_writes_every_slot_and_clock_is_shared():
    """The JAX engine's two quirks, kept: admitting a request writes its
    prompt into every slot's cache rows, and one step runs all slots at
    the largest active position."""
    cfg = tf.TransformerConfig(**LM)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, params, batch_slots=3, max_len=16, device="cpu")
    eng.submit(Request(prompt=np.array([5, 6, 7]), max_new_tokens=2))
    eng._admit()
    ck = eng.cache[0]
    assert bool((ck[:, :, :3] != 0).any(dim=(2, 3, 4)).all())       # every slot, every layer
    assert bool((ck[:, :, 3:] == 0).all())
    eng.submit(Request(prompt=np.array([9]), max_new_tokens=1))
    eng.step()                                                     # runs at max(3, 1) = 3
    assert bool((eng.cache[0][:, :, 3] != 0).any())
    assert bool((eng.cache[0][:, :, 4:] == 0).all())


def test_engine_and_serve_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tf.TransformerConfig(**LM)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, {}, batch_slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve_din(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.resolve_device(None)


@pytest.mark.parametrize("arch", ["graph", "gcn-cora", "mace"])
def test_serve_refuses_what_is_not_ported(arch, capsys, monkeypatch):
    """A GNN arch has no serving path and is refused with the JAX
    launcher's message, before any server starts; ``graph`` (online graph
    serving) serves instead."""
    if arch == "graph":
        serve.main(["--arch", arch, "--device", "cpu", "--requests", "8"])
        assert capsys.readouterr().out.startswith("[serve] graph/uniform: 8 ops in ")
        return

    def no_server(*args, **kwargs):
        raise AssertionError("a GNN arch reached a server")

    monkeypatch.setattr(serve, "serve_din", no_server)
    monkeypatch.setattr(serve, "serve_lm", no_server)
    with pytest.raises(SystemExit, match=f"^{arch} \\(gnn\\) has no serving path; use train$"):
        serve.main(["--arch", arch, "--device", "cpu"])


@pytest.mark.parametrize("arch,expect", [
    ("granite-3-8b", "128 tokens"), ("din", "req/s"), ("yi-34b", "128 tokens"),
    ("deepseek-coder-33b", "128 tokens"), ("deepseek-moe-16b", "128 tokens"),
    ("qwen3-moe-30b-a3b", "128 tokens"),
])
def test_serve_cli_runs_on_cpu(arch, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cpu",
         "--requests", "8"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
