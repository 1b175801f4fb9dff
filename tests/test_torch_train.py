"""Port parity for the training path: AdamW, checkpoints, gradients, the
trainer and the training launchers, against the JAX package on the CPU.

Inputs come from numpy seeds; weights are drawn by the JAX package and
carried across as numpy (``repro_torch.convert``). Bars, each with its
reason:

* AdamW: the schedule and three ``update`` steps within 1e-6 (the same ops
  in the same order; sums over a leaf in another order);
* checkpoints: float32, integer and bfloat16 leaves bit for bit across the
  packages (the same npz bytes per leaf);
* gradients of one step against ``jax.grad``: every leaf within 1e-5 of
  its largest entry (float32 sums in another order, through up to four
  layers). The MoE cases first assert that no token's k-th and (k+1)-th
  router probabilities lie within 1e-5 of each other: top-k is
  discontinuous, so a tie within rounding (the frameworks' hidden states
  differ by ~1e-6) would send a token to another expert in one package, a
  discrete change that is not a fault of either;
* the trainer against the JAX trainer over 10 steps: losses and gradient
  norms within ``LOSS_RTOL`` (measured on the launcher's dense config: at
  most 3.3e-7 over 40 steps). The MoE launcher configs over 40 steps:
  losses within ``MOE_LOSS_RTOL``. Over 40 steps of 1,024 tokens some
  token meets a router near-tie, and the flip moves the loss (measured:
  up to 1.4e-4 on deepseek-moe-16b's reduced config, 2.7e-5 on
  qwen3-moe-30b-a3b's, 1.3e-3 with two kv heads; within 3.6e-7 over the
  first 10 steps, before any flip);
* a re-dispatched step bit-equal to a single one (the step is pure).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import LmDataConfig as JaxLmDataConfig
from repro.data.pipeline import lm_token_stream as jax_lm_token_stream
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_tf
from repro.models.moe import MoeConfig as JaxMoeConfig
from repro.optim import adamw as jax_adamw
from repro.train import checkpoint as jax_ckpt
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainerConfig as JaxTrainerConfig
from repro_torch import convert
from repro_torch.data.pipeline import LmDataConfig, din_stream, lm_token_stream
from repro_torch.launch import train as launch_train
from repro_torch.models import moe, recsys
from repro_torch.models import transformer as tf
from repro_torch.models.moe import MoeConfig
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import FaultInjector, StragglerMitigator
from repro_torch.train.loop import Trainer, TrainerConfig

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

#: the trainer's loss and gradient-norm bar against the JAX trainer
LOSS_RTOL = 1e-5
#: the same for the MoE configs over 40 steps, where routing flips at near-ties
MOE_LOSS_RTOL = 1e-2
#: TestTrainerFaultTolerance's tiny LM
TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=64)
#: the training launcher's reduced config (n_kv_heads per arch)
REDUCED = dict(n_layers=4, d_model=128, n_heads=8, d_ff=512, vocab=512)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, dtype=np.float32) if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)


def _assert_tree_close(got, want, rel, what="", zero=()):
    """Every leaf within ``rel`` of its largest entry; the leaves in ``zero``,
    whose gradient is 0 in exact arithmetic, within ``rel`` of the tree's
    largest entry (their values are rounding noise)."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    top = max(float(np.abs(_as_np(v)).max()) for v in w.values())
    for key in zero:
        assert max(float(np.abs(_as_np(d[key])).max()) for d in (g, w)) <= rel * top, f"{what} {key}"
    for key in sorted(set(w) - set(zero)):
        a, b = _as_np(g[key]), _as_np(w[key])
        assert a.shape == b.shape, f"{what} {key}"
        scale = max(float(np.abs(b).max()), 1e-30)
        gap = float(np.abs(a.astype(np.float64) - b).max())
        assert gap <= rel * scale, f"{what} {key}: max gap {gap:.3g} > {rel} x {scale:.3g}"


def _jax_batches(stream):
    return map(lambda b: {k: jnp.asarray(v) for k, v in b.items()}, stream)


def _torch_batches(stream):
    return map(lambda b: {k: torch.as_tensor(v) for k, v in b.items()}, stream)


def _port_value_and_grad(loss_fn, params, batch):
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(live, batch)
    names = sorted(_flat(live))
    leaves = [_flat(live)[n] for n in names]
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    return float(loss.detach()), grads


# -------------------------------------------------------------------- AdamW
def _adamw_trees(seed, dtype):
    rng = np.random.default_rng(seed)
    p = {"a": rng.normal(size=(5, 3)), "n": {"b": rng.normal(size=7), "c": rng.normal(size=(2, 2, 3))}}
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape) * 3, p) for _ in range(3)]
    cast = lambda t: jax.tree.map(lambda x: x.astype(dtype), t)
    return cast(p), [cast(g) for g in grads]


def _port_tree(tree):
    return convert._tree(tree, torch.device("cpu"))


def test_cosine_schedule_matches_jax():
    cfg = dict(lr=2e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jlr = jax_adamw.cosine_schedule(jax_adamw.AdamWConfig(**cfg))
    lr = adamw.cosine_schedule(adamw.AdamWConfig(**cfg))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(lr(torch.tensor(step, dtype=torch.int32))),
                                   float(jlr(jnp.int32(step))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_matches_jax_three_steps(dtype):
    """Three updates from the same trees: parameters, moments, step, lr and
    the pre-clip norm within 1e-6 (bfloat16 parameters: equal after
    rounding to bfloat16, with float32 moments)."""
    np_dtype = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    p, grads = _adamw_trees(0, np_dtype)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=4.0)
    jp, js = jax.tree.map(jnp.asarray, p), jax_adamw.init(jax.tree.map(jnp.asarray, p))
    tp = _port_tree(p)
    ts = adamw.init(tp)
    for g in grads:
        jp, js, jm = jax_adamw.update(jp, jax.tree.map(jnp.asarray, g), js, jax_adamw.AdamWConfig(**cfg))
        tp, ts, tm = adamw.update(tp, _port_tree(g), ts, adamw.AdamWConfig(**cfg))
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == 3
    assert all(t.dtype == torch.float32 for t in _flat({"m": ts["m"], "v": ts["v"]}).values())
    assert all(t.dtype == getattr(torch, dtype) for t in _flat(tp).values())
    _assert_tree_close({"m": ts["m"], "v": ts["v"]}, _np({"m": js["m"], "v": js["v"]}), 1e-6, "moments")
    if dtype == "float32":
        _assert_tree_close(tp, _np(jp), 1e-6, "params")
    else:
        for key, want in _flat(_np(jp)).items():
            np.testing.assert_array_equal(_flat(tp)[key].float().numpy(), want.astype(np.float32), err_msg=key)


def test_update_is_pure():
    p, grads = _adamw_trees(1, np.float32)
    tp, g = _port_tree(p), _port_tree(grads[0])
    state = adamw.init(tp)
    before = {k: v.clone() for k, v in _flat({"p": tp, "g": g, "s": state}).items()}
    new_p, new_s, _ = adamw.update(tp, g, state, adamw.AdamWConfig(warmup_steps=0))
    after = _flat({"p": tp, "g": g, "s": state})
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert not torch.equal(new_p["a"], tp["a"]) and int(new_s["step"]) == 1


def test_update_in_slices_changes_no_bit(monkeypatch):
    """A leaf larger than ``CHUNK_ELEMENTS`` is updated in slices of its
    leading axis; the result equals the whole-leaf update bit for bit."""
    rng = np.random.default_rng(3)
    p = _port_tree({"w": rng.normal(size=(5, 30, 4)).astype(np.float32),
                    "e": rng.normal(size=(100, 7)).astype(jnp.bfloat16), "b": rng.normal(size=3).astype(np.float32)})
    g = adamw.tree_map(lambda t: torch.as_tensor(rng.normal(size=t.shape).astype(np.float32)).to(t.dtype), p)
    state = adamw.init(p)
    whole = adamw.update(p, g, state, adamw.AdamWConfig(warmup_steps=0))
    monkeypatch.setattr(adamw, "CHUNK_ELEMENTS", 100)
    sliced = adamw.update(p, g, state, adamw.AdamWConfig(warmup_steps=0))
    a, b = _flat({"p": whole[0], "s": whole[1]}), _flat({"p": sliced[0], "s": sliced[1]})
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_tree_unflatten_keeps_no_reference_to_its_values():
    """A step's gradients go when the step returns, without waiting for the
    cyclic garbage collector (a self-referencing closure would hold them)."""
    import gc
    import weakref

    values = (torch.ones(3), torch.ones(2))
    ref = weakref.ref(values[0])
    gc.disable()
    try:
        tree = adamw.tree_unflatten({"a": 0, "b": {"c": 0}}, values)
        assert torch.equal(tree["a"], values[0]) and torch.equal(tree["b"]["c"], values[1])
        del values, tree
        assert ref() is None
    finally:
        gc.enable()


class TestAdamW:
    """Twins of ``tests/test_train.py::TestAdamW``."""

    def test_converges_on_quadratic(self):
        target = torch.as_tensor(np.random.default_rng(0).normal(size=(8,)).astype(np.float32))
        params = {"w": torch.zeros(8)}
        state = adamw.init(params)
        cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=300,
                                min_lr_ratio=1.0)
        for _ in range(300):
            grads = {"w": 2 * (params["w"] - target)}
            params, state, _ = adamw.update(params, grads, state, cfg)
        np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)

    def test_clipping(self):
        params = {"w": torch.zeros(4)}
        _, _, m = adamw.update(params, {"w": torch.full((4,), 1e6)}, adamw.init(params),
                               adamw.AdamWConfig(clip_norm=1.0, warmup_steps=0))
        assert float(m["grad_norm"]) > 1e5  # reported pre-clip

    def test_schedule_shape(self):
        lr = adamw.cosine_schedule(adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                                     min_lr_ratio=0.1))
        assert float(lr(torch.tensor(5, dtype=torch.int32))) == pytest.approx(0.5)
        assert float(lr(torch.tensor(10, dtype=torch.int32))) == pytest.approx(1.0, rel=1e-3)
        assert float(lr(torch.tensor(100, dtype=torch.int32))) == pytest.approx(0.1, rel=1e-3)

    def test_bf16_params_fp32_state(self):
        params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
        state = adamw.init(params)
        assert state["m"]["w"].dtype == torch.float32
        new_p, _, _ = adamw.update(params, {"w": torch.ones(4, dtype=torch.bfloat16)}, state,
                                   adamw.AdamWConfig())
        assert new_p["w"].dtype == torch.bfloat16


# -------------------------------------------------------------- checkpoints
class TestCheckpoint:
    """Twins of ``tests/test_train.py::TestCheckpoint``."""

    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(5), "nested": {"b": torch.ones((2, 3))},
                "step": torch.tensor(7, dtype=torch.int32)}
        ckpt.save(str(tmp_path), 7, tree)
        step, tree2, _ = ckpt.restore_latest(str(tmp_path), tree)
        assert step == 7
        np.testing.assert_array_equal(tree2["a"].numpy(), np.arange(5))
        assert tree2["step"].dtype == torch.int32 and int(tree2["step"]) == 7

    def test_keeps_latest_k(self, tmp_path):
        tree = {"x": torch.zeros(2)}
        for s in range(6):
            ckpt.save(str(tmp_path), s, tree, keep=2)
        assert len([f for f in os.listdir(tmp_path) if f.endswith("manifest.json")]) == 2
        assert ckpt.restore_latest(str(tmp_path), tree)[0] == 5

    def test_corrupt_falls_back(self, tmp_path):
        tree = {"x": torch.arange(3)}
        ckpt.save(str(tmp_path), 1, tree, keep=5)
        ckpt.save(str(tmp_path), 2, tree, keep=5)
        for f in os.listdir(tmp_path):
            if f.startswith("ckpt_00000002") and f.endswith(".npz"):
                (tmp_path / f).write_bytes(b"garbage")
        assert ckpt.restore_latest(str(tmp_path), tree)[0] == 1

    def test_async_save(self, tmp_path):
        tree = {"x": torch.arange(4, dtype=torch.float32)}
        ckpt.save_async(str(tmp_path), 3, tree).join(timeout=30)
        step, back, _ = ckpt.restore_latest(str(tmp_path), tree)
        assert step == 3 and torch.equal(back["x"], tree["x"])


def _mixed_tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "layers": {"b": rng.normal(size=(2, 5)).astype(np.float32)}},
            "opt": {"step": np.int32(11), "count": np.arange(6, dtype=np.int32)}}


def test_jax_checkpoint_restored_by_port_bit_for_bit(tmp_path):
    tree = _mixed_tree(0)
    jax_ckpt.save(str(tmp_path), 11, jax.tree.map(jnp.asarray, tree), extra={"note": "jax"})
    template = adamw.tree_map(lambda a: torch.zeros(np.shape(a), dtype=torch.as_tensor(a).dtype), tree)
    step, back, extra = ckpt.restore_latest(str(tmp_path), template)
    assert step == 11 and extra == {"note": "jax"}
    for key, want in _flat(tree).items():
        got = _flat(back)[key].numpy()
        assert got.dtype == np.asarray(want).dtype and np.array_equal(got, want), key


def test_port_checkpoint_restored_by_jax_bit_for_bit(tmp_path):
    tree = _mixed_tree(1)
    ckpt.save(str(tmp_path / "port"), 11, _port_tree(tree))
    jax_ckpt.save(str(tmp_path / "jax"), 11, jax.tree.map(jnp.asarray, tree))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    step, back, _ = jax_ckpt.restore_latest(str(tmp_path / "port"), jax.tree.map(jnp.asarray, tree))
    assert step == 11
    for key, want in _flat(tree).items():
        got = np.asarray(_flat(back)[key])
        assert got.dtype == np.asarray(want).dtype and np.array_equal(got, want), key
    with np.load(tmp_path / "port" / "ckpt_00000011.npz") as a, np.load(tmp_path / "jax" / "ckpt_00000011.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_bf16_leaf_written_as_jax_writes_it_and_restored(tmp_path):
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.normal(size=(4, 6)), dtype=jnp.bfloat16)
    jax_ckpt.save(str(tmp_path / "jax"), 1, {"w": w, "m": jnp.ones(3)})
    template = {"w": torch.zeros((4, 6), dtype=torch.bfloat16), "m": torch.zeros(3)}
    step, back, _ = ckpt.restore_latest(str(tmp_path / "jax"), template)
    want_bits = np.asarray(w).view(np.int16)
    assert step == 1 and back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].view(torch.int16).numpy(), want_bits)
    ckpt.save(str(tmp_path / "port"), 1, back)
    with np.load(tmp_path / "port" / "ckpt_00000001.npz") as a, np.load(tmp_path / "jax" / "ckpt_00000001.npz") as b:
        assert a["w"].dtype == b["w"].dtype == np.dtype("V2")
        assert a["w"].tobytes() == b["w"].tobytes()
    _, again, _ = ckpt.restore_latest(str(tmp_path / "port"), template)
    assert torch.equal(again["w"].view(torch.int16), back["w"].view(torch.int16))


# ---------------------------------------------------------------- gradients
def _lm_pair(fields, moe_fields=None):
    jcfg = jax_tf.TransformerConfig(**fields, moe=JaxMoeConfig(**moe_fields) if moe_fields else None)
    cfg = tf.TransformerConfig(**fields, moe=MoeConfig(**moe_fields) if moe_fields else None)
    jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, convert.transformer_params_from_arrays(_np(jparams), device="cpu")


def _router_margin(cfg, params, tokens):
    """The smallest gap between a token's k-th and (k+1)-th router
    probability over every MoE layer of the port's forward."""
    probs, route = [], moe.route

    def recording(p, xf, c):
        out = route(p, xf, c)
        probs.append(out[0])
        return out

    moe.route = recording
    try:
        with torch.no_grad():
            tf.forward(cfg, params, tokens)
    finally:
        moe.route = route
    k = cfg.moe.top_k
    return min(float((s[:, k - 1] - s[:, k]).min()) for s in (torch.sort(p, -1, descending=True)[0] for p in probs))


LM_GRAD_CASES = {
    "tiny": (TINY, None, dict(vocab=64, seq_len=16, batch=4)),
    "dense_reduced": (dict(REDUCED, n_kv_heads=2), None, dict(vocab=512, seq_len=64, batch=4)),
    # qwen3-moe-30b-a3b's reduced config, and deepseek-moe-16b's at a
    # capacity factor of 0.5, where every expert's capacity (32) is below
    # the mean load (64), so assignments drop.
    "moe_reduced": (dict(REDUCED, n_kv_heads=1), dict(n_experts=8, top_k=2, n_shared=0, d_ff=128),
                    dict(vocab=512, seq_len=64, batch=4)),
    "moe_reduced_drops": (dict(REDUCED, n_kv_heads=8),
                          dict(n_experts=8, top_k=2, n_shared=1, d_ff=128, capacity_factor=0.5),
                          dict(vocab=512, seq_len=64, batch=4)),
}


@pytest.mark.parametrize("name", list(LM_GRAD_CASES))
def test_lm_gradients_match_jax_grad(name):
    fields, moe_fields, data = LM_GRAD_CASES[name]
    jcfg, cfg, jparams, params = _lm_pair(fields, moe_fields)
    batch = next(lm_token_stream(LmDataConfig(**data)))
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    if moe_fields:
        margin = _router_margin(cfg, params, tbatch["tokens"])
        assert margin > 1e-5, f"a router near-tie ({margin:.2e}) would make the comparison a coin toss"
    if name == "moe_reduced_drops":
        from repro_torch.models.moe import capacity
        assert capacity(data["batch"] * data["seq_len"], cfg.moe) < data["batch"] * data["seq_len"] * 2 // 8
    jloss, jgrads = jax.value_and_grad(lambda p: jax_tf.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)))(jparams)
    loss, grads = _port_value_and_grad(lambda p, b: tf.loss_fn(cfg, p, b), params, tbatch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    want = _flat(_np(jgrads))
    assert sorted(grads) == sorted(want)
    _assert_tree_close(grads, want, 1e-5, name)
    for layer in range(cfg.n_layers):
        for w in ("wq", "wk", "wv"):
            assert float(grads[f"layers/attn/{w}"][layer].abs().max()) > 0, (w, layer)


def test_din_bce_gradients_match_jax_grad():
    jcfg = jax_recsys.DinConfig(n_items=2000, n_cats=50, seq_len=20)
    cfg = recsys.DinConfig(n_items=2000, n_cats=50, seq_len=20)
    jparams = jax_recsys.init(jcfg, jax.random.PRNGKey(0))
    params = convert.din_params_from_arrays(_np(jparams), device="cpu")
    batch = next(din_stream(batch=64, seq_len=20, n_items=2000, n_cats=50))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_recsys.bce_loss(jcfg, p, jax.tree.map(jnp.asarray, batch)))(jparams)
    loss, grads = _port_value_and_grad(lambda p, b: recsys.bce_loss(cfg, p, b), params,
                                       {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    # attn/b2 shifts every history score alike, which the softmax cancels.
    _assert_tree_close(grads, _flat(_np(jgrads)), 1e-5, "din", zero=("attn/b2",))


# ------------------------------------------------------------------ trainer
def _trainers(tmp_path, steps=10, fields=TINY, data=dict(vocab=64, seq_len=16, batch=4), **tcfg):
    jcfg, cfg, jparams, params = _lm_pair(fields)
    opt = dict(lr=3e-3, warmup_steps=2)
    jtr = JaxTrainer(lambda p, b: jax_tf.loss_fn(jcfg, p, b), jparams, jax_adamw.AdamWConfig(**opt),
                     JaxTrainerConfig(total_steps=steps, ckpt_dir=str(tmp_path / "jax"), ckpt_every=4,
                                      log_every=1, **tcfg))
    tr = Trainer(lambda p, b: tf.loss_fn(cfg, p, b), params, adamw.AdamWConfig(**opt),
                 TrainerConfig(total_steps=steps, ckpt_dir=str(tmp_path / "port"), ckpt_every=4,
                               log_every=1, **tcfg))
    return jtr, tr, data


def _stacked(stream, n):
    while True:
        bs = [next(stream) for _ in range(n)]
        yield {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _assert_same_run(jtr, tr, tmp_path):
    assert tr.step == jtr.step
    assert [m["step"] for m in tr.metrics_log] == [m["step"] for m in jtr.metrics_log]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in tr.metrics_log], [m[key] for m in jtr.metrics_log],
                                   rtol=LOSS_RTOL, err_msg=key)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("tcfg", [{}, {"grad_accum": 2}, {"bf16_grads": True}],
                         ids=["plain", "grad_accum_2", "bf16_grads"])
def test_trainer_follows_jax_trainer(tmp_path, tcfg):
    jtr, tr, data = _trainers(tmp_path, **tcfg)
    n = tcfg.get("grad_accum", 1)
    jstream = jax_lm_token_stream(JaxLmDataConfig(**data))
    stream = lm_token_stream(LmDataConfig(**data))
    if n > 1:
        jstream, stream = _stacked(jstream, n), _stacked(stream, n)
    jtr.fit(_jax_batches(jstream))
    tr.fit(_torch_batches(stream))
    assert tr.step == 10
    _assert_same_run(jtr, tr, tmp_path)


def test_trainer_follows_jax_trainer_at_launcher_config(tmp_path):
    jtr, tr, data = _trainers(tmp_path, fields=dict(REDUCED, n_kv_heads=2),
                              data=dict(vocab=512, seq_len=128, batch=8))
    jtr.fit(_jax_batches(jax_lm_token_stream(JaxLmDataConfig(**data))))
    tr.fit(_torch_batches(lm_token_stream(LmDataConfig(**data))))
    _assert_same_run(jtr, tr, tmp_path)


@pytest.mark.parametrize("kv,shared", [(8, 1), (1, 0)], ids=["deepseek-moe-16b", "qwen3-moe-30b-a3b"])
def test_moe_trainer_follows_jax_trainer(kv, shared):
    """The training launcher's MoE run (its config, data and optimizer, 40
    steps) in both packages from the same weights."""
    steps, data = 40, dict(vocab=512, seq_len=128, batch=8)
    jcfg, cfg, jparams, params = _lm_pair(dict(REDUCED, n_kv_heads=kv),
                                          dict(n_experts=8, top_k=2, n_shared=shared, d_ff=128))
    opt = dict(lr=3e-3, warmup_steps=10, total_steps=steps)
    jtr = JaxTrainer(lambda p, b: jax_tf.loss_fn(jcfg, p, b), jparams, jax_adamw.AdamWConfig(**opt),
                     JaxTrainerConfig(total_steps=steps, log_every=4))
    tr = Trainer(lambda p, b: tf.loss_fn(cfg, p, b), params, adamw.AdamWConfig(**opt),
                 TrainerConfig(total_steps=steps, log_every=4))
    jtr.fit(_jax_batches(jax_lm_token_stream(JaxLmDataConfig(**data))))
    tr.fit(_torch_batches(lm_token_stream(LmDataConfig(**data))))
    np.testing.assert_allclose([m["loss"] for m in tr.metrics_log], [m["loss"] for m in jtr.metrics_log],
                               rtol=MOE_LOSS_RTOL)


def test_redispatched_step_equals_single_step():
    """Every step re-dispatched (a zero deadline) gives the same state, bit
    for bit, as a run that never re-dispatches: the step is pure."""
    runs = []
    for mitigator in (StragglerMitigator(min_samples=10 ** 9), StragglerMitigator(deadline_factor=0.0, min_samples=0)):
        _, cfg, _, params = _lm_pair(TINY)
        tr = Trainer(lambda p, b: tf.loss_fn(cfg, p, b), params, adamw.AdamWConfig(lr=3e-3, warmup_steps=2),
                     TrainerConfig(total_steps=6, log_every=1))
        tr.straggler = mitigator
        tr.fit(_torch_batches(lm_token_stream(LmDataConfig(vocab=64, seq_len=16, batch=4))))
        runs.append(tr)
    assert runs[0].straggler.redispatches == 0 and runs[1].straggler.redispatches == 6
    a, b = _flat(runs[0].state), _flat(runs[1].state)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_unused_leaf_gets_zero_gradient_and_decays_as_in_jax():
    """A leaf the loss does not reach: the JAX trainer gives it a zero
    gradient and AdamW decays it; the port's trainer must too (it used to
    raise in ``torch.autograd.grad``)."""
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(3, 2)).astype(np.float32), "unused": {"b": np.ones(4, np.float32)}}
    x = rng.normal(size=(5, 3)).astype(np.float32)
    opt = dict(lr=1e-2, warmup_steps=2, weight_decay=0.1)
    jtr = JaxTrainer(lambda q, _: jnp.sum((jnp.asarray(x) @ q["a"]) ** 2), jax.tree.map(jnp.asarray, p),
                     jax_adamw.AdamWConfig(**opt), JaxTrainerConfig(total_steps=10, log_every=1))
    jtr.fit(iter(lambda: {"_": jnp.zeros(())}, None))
    xt = torch.as_tensor(x)
    tr = Trainer(lambda q, _: torch.sum((xt @ q["a"]) ** 2), _port_tree(p), adamw.AdamWConfig(**opt),
                 TrainerConfig(total_steps=10, log_every=1))
    tr.fit(iter(lambda: {}, None))
    assert tr.step == jtr.step == 10
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in tr.metrics_log], [m[key] for m in jtr.metrics_log],
                                   rtol=LOSS_RTOL, err_msg=key)
    b, jb = tr.state["params"]["unused"]["b"].numpy(), np.asarray(jtr.state["params"]["unused"]["b"])
    assert np.all(b < 1) and np.all(jb < 1)
    np.testing.assert_allclose(b, jb, rtol=1e-6)
    assert not bool(tr.state["opt"]["m"]["unused"]["b"].any()) and not bool(tr.state["opt"]["v"]["unused"]["b"].any())


def test_jax_train_state_resumed_by_port():
    """A JAX train state after 5 steps, carried over by ``convert``, trains
    on in the port like the JAX trainer's own steps 6 to 10."""
    data = dict(vocab=64, seq_len=16, batch=4)
    jcfg, cfg, jparams, _ = _lm_pair(TINY)
    opt = dict(lr=3e-3, warmup_steps=2)

    def jax_run(steps):
        jtr = JaxTrainer(lambda p, b: jax_tf.loss_fn(jcfg, p, b), jparams, jax_adamw.AdamWConfig(**opt),
                         JaxTrainerConfig(total_steps=steps, log_every=1))
        jtr.fit(_jax_batches(jax_lm_token_stream(JaxLmDataConfig(**data))))
        return jtr

    full, half = jax_run(10), jax_run(5)
    tr = Trainer(lambda p, b: tf.loss_fn(cfg, p, b),
                 convert.transformer_params_from_arrays(_np(half.state["params"]), device="cpu"),
                 adamw.AdamWConfig(**opt), TrainerConfig(total_steps=10, log_every=1))
    tr.state["opt"] = convert.adamw_state_from_arrays(_np(half.state["opt"]), device="cpu")
    tr.step = 5
    stream = lm_token_stream(LmDataConfig(**data))
    for _ in range(5):
        next(stream)
    tr.fit(_torch_batches(stream))
    assert [m["step"] for m in tr.metrics_log] == [6, 7, 8, 9, 10]
    np.testing.assert_allclose([m["loss"] for m in tr.metrics_log],
                               [m["loss"] for m in full.metrics_log[5:]], rtol=LOSS_RTOL)


def test_jax_checkpoint_resumed_by_port_trainer(tmp_path):
    """The port's trainer restores the JAX trainer's checkpoint at
    construction and goes on as the JAX trainer does from it."""
    import shutil

    data = dict(vocab=64, seq_len=16, batch=4)
    jcfg, cfg, jparams, params = _lm_pair(TINY)
    opt, jdir, pdir = dict(lr=3e-3, warmup_steps=2), str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cfg = lambda n: JaxTrainerConfig(total_steps=n, ckpt_dir=jdir, ckpt_every=4, log_every=1)
    JaxTrainer(lambda p, b: jax_tf.loss_fn(jcfg, p, b), jparams, jax_adamw.AdamWConfig(**opt),
               jax_cfg(8)).fit(_jax_batches(jax_lm_token_stream(JaxLmDataConfig(**data))))
    shutil.copytree(jdir, pdir)
    tr = Trainer(lambda p, b: tf.loss_fn(cfg, p, b), params, adamw.AdamWConfig(**opt),
                 TrainerConfig(total_steps=12, ckpt_dir=pdir, ckpt_every=4, log_every=1))
    jtr = JaxTrainer(lambda p, b: jax_tf.loss_fn(jcfg, p, b), jparams, jax_adamw.AdamWConfig(**opt), jax_cfg(12))
    assert tr.step == jtr.step == 8 and int(tr.state["opt"]["step"]) == 8
    jtr.fit(_jax_batches(jax_lm_token_stream(JaxLmDataConfig(**data))))
    tr.fit(_torch_batches(lm_token_stream(LmDataConfig(**data))))
    np.testing.assert_allclose([m["loss"] for m in tr.metrics_log], [m["loss"] for m in jtr.metrics_log],
                               rtol=LOSS_RTOL)


class TestTrainerFaultTolerance:
    """Twins of ``tests/test_train.py::TestTrainerFaultTolerance``."""

    def _mk(self, d, fail_at=(), steps=12):
        cfg = tf.TransformerConfig(**TINY)
        params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        data = _torch_batches(lm_token_stream(LmDataConfig(vocab=64, seq_len=16, batch=4)))
        tr = Trainer(
            lambda p, b: tf.loss_fn(cfg, p, b), params,
            adamw.AdamWConfig(lr=3e-3, warmup_steps=2),
            TrainerConfig(total_steps=steps, ckpt_dir=d, ckpt_every=4, log_every=2),
            fault_injector=FaultInjector(fail_at_steps=fail_at),
        )
        return tr, data

    def test_loss_decreases(self, tmp_path):
        tr, data = self._mk(str(tmp_path), steps=40)
        tr.fit(data)
        losses = [m["loss"] for m in tr.metrics_log]
        assert np.mean(losses[-3:]) < np.mean(losses[:3])

    def test_recovers_from_injected_failure(self, tmp_path):
        tr, data = self._mk(str(tmp_path), fail_at=(6,))
        final = tr.fit(data)
        assert tr.step == 12 and tr.recoveries == 1
        assert np.isfinite(final["loss"])

    def test_restart_resumes_from_checkpoint(self, tmp_path):
        tr, data = self._mk(str(tmp_path))
        tr.fit(data)
        tr2, _ = self._mk(str(tmp_path))
        assert tr2.step == 12  # restored at final step, nothing left


# ---------------------------------------------------------------- launchers
@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-moe-16b", "din", "gcn-cora", "graphsage-reddit",
                                  "meshgraphnet", "mace"])
def test_launch_train_on_cpu(arch, tmp_path):
    tr = launch_train.main(["--arch", arch, "--steps", "20", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in tr.metrics_log]
    assert tr.step == 20 and len(losses) == 10 and np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert "ckpt_00000020.manifest.json" in os.listdir(tmp_path)


def test_launch_train_recovers_from_fault(tmp_path):
    tr = launch_train.train_lm("qwen3-moe-30b-a3b", 12, str(tmp_path), device="cpu",
                               fault_injector=FaultInjector(fail_at_steps=(6,)))
    assert tr.step == 12 and tr.recoveries == 1
    assert np.isfinite(tr.metrics_log[-1]["loss"])


@pytest.mark.parametrize("arch", ["no-such-arch"])
def test_launch_train_refuses_unported_archs(arch):
    with pytest.raises(KeyError, match=arch):
        launch_train.main(["--arch", arch, "--device", "cpu"])


def test_lm_training_example_recovers(capsys):
    from repro_torch import lm_training

    tr = lm_training.main(["--steps", "20", "--device", "cpu"])
    assert tr.step == 20 and tr.recoveries == 1
    out = capsys.readouterr().out
    assert "injected node failure at step 10" in out and "loss:" in out
