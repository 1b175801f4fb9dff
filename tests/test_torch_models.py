"""Port parity for the model paths: shared layers, the dense LM, DIN and
the data pipeline, against the JAX package on the CPU.

Inputs come from numpy seeds; weights are drawn by the JAX package and
carried across as numpy (``repro_torch.convert``). Bars: layers within
1e-5 (float32 sums taken in another order); the LM's logits, loss,
``serve_step`` logits and caches within 1e-4 against the JAX path that runs
the Pallas flash kernel in interpret mode (measured gap: under 3e-6, two
layers deep); DIN within 1e-5, ``user_vector`` against JAX's
EmbeddingBag-kernel path; data batches bit-equal. The bfloat16 forward is
held to the float32 forward, and to the JAX package's bfloat16 forward,
with bars from bfloat16's 8-bit mantissa (see
``test_bf16_forward_tracks_float32``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.models import layers as jax_layers
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_tf
from repro_torch import convert
from repro_torch.data import pipeline
from repro_torch.models import layers, recsys
from repro_torch.models import transformer as tf

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_tf.TransformerConfig(**LM, use_flash_kernel=True)
    jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = tf.TransformerConfig(**LM)
    params = convert.transformer_params_from_arrays(_np_tree(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _t(a):
    return torch.as_tensor(np.array(a))


# ----------------------------------------------------------------- layers
def _layer_case(name):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    if name == "rmsnorm":
        p = {"scale": rng.normal(size=64).astype(np.float32)}
        return (jax_layers.rmsnorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)),
                layers.rmsnorm(jax.tree.map(_t, p), _t(x)))
    if name == "layernorm":
        p = {"scale": rng.normal(size=64).astype(np.float32), "bias": rng.normal(size=64).astype(np.float32)}
        return (jax_layers.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)),
                layers.layernorm(jax.tree.map(_t, p), _t(x)))
    if name in ("apply_rope", "apply_rope_batched"):
        xh = x.reshape(2, 9, 4, 16)
        pos = np.arange(9) + 5 if name == "apply_rope" else rng.integers(0, 500, size=(2, 9))
        return (jax_layers.apply_rope(jnp.asarray(xh), jnp.asarray(pos)),
                layers.apply_rope(_t(xh), _t(pos)))
    if name == "attention_fwd":
        p = _np_tree(jax_layers.attention_init(key, 64, 4, 2, 16))
        return (jax_layers.attention_fwd(jax.tree.map(jnp.asarray, p), jnp.asarray(x), 4, 2, use_kernel=True),
                layers.attention_fwd(jax.tree.map(_t, p), _t(x), 4, 2))
    if name == "decode_attention":
        p = _np_tree(jax_layers.attention_init(key, 64, 4, 2, 16))
        ck = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
        cv = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
        out, (jck, jcv) = jax_layers.decode_attention(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x[:, :1]), 4, 2,
            (jnp.asarray(ck), jnp.asarray(cv)), jnp.int32(7))
        got, (tck, tcv) = layers.decode_attention(
            jax.tree.map(_t, p), _t(x[:, :1]), 4, 2, (_t(ck.copy()), _t(cv.copy())), 7)
        np.testing.assert_allclose(tck.numpy(), np.asarray(jck), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv), rtol=1e-5, atol=1e-5)
        return out, got
    if name == "swiglu":
        p = _np_tree(jax_layers.swiglu_init(key, 64, 96))
        return (jax_layers.swiglu(jax.tree.map(jnp.asarray, p), jnp.asarray(x)),
                layers.swiglu(jax.tree.map(_t, p), _t(x)))
    if name == "mlp":
        p = _np_tree(jax_layers.mlp_init(key, (64, 40, 20, 1)))
        return (jax_layers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x)),
                layers.mlp(jax.tree.map(_t, p), _t(x)))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["rmsnorm", "layernorm", "apply_rope", "apply_rope_batched",
                                  "attention_fwd", "decode_attention", "swiglu", "mlp"])
def test_layer_matches_jax(name):
    want, got = _layer_case(name)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_rmsnorm_keeps_the_input_type():
    x = torch.randn(3, 64).to(torch.bfloat16)
    y = layers.rmsnorm({"scale": torch.ones(64, dtype=torch.bfloat16)}, x)
    assert y.dtype == torch.bfloat16


# --------------------------------------------------------------------- LM
def test_forward_and_loss_match_jax_flash_path(lm):
    jcfg, jparams, cfg, params = lm
    batch = next(pipeline.lm_token_stream(pipeline.LmDataConfig(vocab=128, seq_len=64, batch=2, seed=4)))
    jlogits, _ = jax_tf.forward(jcfg, jparams, jnp.asarray(batch["tokens"]))
    logits, aux = tf.forward(cfg, params, torch.as_tensor(batch["tokens"]))
    assert tuple(logits.shape) == (2, 64, 128) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    jloss = jax_tf.loss_fn(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = tf.loss_fn(cfg, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, atol=1e-4)


def test_serve_step_logits_and_caches_match_jax(lm):
    jcfg, jparams, cfg, params = lm
    toks = np.random.default_rng(5).integers(0, 128, size=(3, 6)).astype(np.int32)
    jcache = jax_tf.init_kv_cache(jcfg, 3, 16)
    cache = tf.init_kv_cache(cfg, 3, 16, device="cpu")
    for t in range(6):
        jlogits, jcache = jax_tf.serve_step(jcfg, jparams, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        logits, cache = tf.serve_step(cfg, params, torch.as_tensor(toks[:, t]), cache, t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    for got, want in zip(cache, jcache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_decode_matches_prefill(lm):
    _, _, cfg, params = lm
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, 128, size=(2, 10)))
    logits, _ = tf.forward(cfg, params, toks)
    cache = tf.init_kv_cache(cfg, 2, 12, device="cpu")
    for t in range(10):
        step, cache = tf.serve_step(cfg, params, toks[:, t], cache, t)
        np.testing.assert_allclose(step.numpy(), logits[:, t].numpy(), rtol=1e-4, atol=1e-4)


def test_bf16_forward_tracks_float32(lm):
    """bfloat16 keeps 8 mantissa bits. The logits here reach |3.4|, where
    one bfloat16 step is 2^-6 ≈ 0.016, and each of the ~12 rounded products,
    sums and norms per layer adds up to half a step of its own operand's
    scale; two layers measured a largest gap of 0.066 (port) and 0.071 (the
    JAX package's own bfloat16 forward) against the float32 forward, with
    the 99th percentile at 0.038. The bar is 0.1 absolute, for both
    frameworks alike, so neither framework's rounding is taken as the truth;
    the two bfloat16 forwards must agree within four steps at the largest
    logit (0.0625; measured 0.039)."""
    jcfg, jparams, cfg, params = lm
    toks = np.random.default_rng(7).integers(0, 128, size=(2, 32)).astype(np.int32)
    want = tf.forward(cfg, params, torch.as_tensor(toks))[0].numpy()
    cfg16 = tf.TransformerConfig(**LM, dtype=torch.bfloat16)
    j16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    p16 = convert.transformer_params_from_arrays(_np_tree(j16), device="cpu")
    assert p16["layers"]["attn"]["wq"].dtype == torch.bfloat16
    got = tf.forward(cfg16, p16, torch.as_tensor(toks))[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-1)
    jcfg16 = jax_tf.TransformerConfig(**LM, dtype=jnp.bfloat16, use_flash_kernel=True)
    jgot = np.asarray(jax_tf.forward(jcfg16, j16, jnp.asarray(toks))[0], dtype=np.float32)
    np.testing.assert_allclose(jgot, want, rtol=0, atol=1e-1)
    np.testing.assert_allclose(got, jgot, rtol=0, atol=0.0625)


def test_init_params_shapes_and_count():
    cfg = tf.TransformerConfig(**LM)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jax_tf.init_abstract(jax_tf.TransformerConfig(**LM)))
    shapes = {k: ({g: {n: tuple(t.shape) for n, t in leaves.items()} for g, leaves in v.items()}
                  if k == "layers" else
                  {n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict) else tuple(v.shape))
              for k, v in params.items()}
    assert shapes == jshapes
    assert cfg.param_count() == jax_tf.TransformerConfig(**LM).param_count()
    assert sum(t.numel() for t in jax.tree.leaves(params)) == cfg.param_count()


# -------------------------------------------------------------------- DIN
@pytest.fixture(scope="module")
def din():
    jcfg = jax_recsys.DinConfig(n_items=500, n_cats=20, seq_len=10)
    jparams = jax_recsys.init(jcfg, jax.random.PRNGKey(0))
    cfg = recsys.DinConfig(n_items=500, n_cats=20, seq_len=10)
    params = convert.din_params_from_arrays(_np_tree(jparams), device="cpu")
    batch = pipeline.din_batch(8, 10, 500, 20, seed=2)
    batch["hist_mask"][3] = 0.0  # an empty history
    return jcfg, jparams, cfg, params, batch


def test_din_forward_and_loss_match_jax(din):
    jcfg, jparams, cfg, params, batch = din
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    np.testing.assert_allclose(recsys.forward(cfg, params, tb).numpy(),
                               np.asarray(jax_recsys.forward(jcfg, jparams, jb)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(recsys.bce_loss(cfg, params, tb)),
                               float(jax_recsys.bce_loss(jcfg, jparams, jb)), rtol=1e-5, atol=1e-5)


def test_din_user_vector_matches_jax_kernel_path(din):
    jcfg, jparams, cfg, params, batch = din
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    got = recsys.user_vector(cfg, params, {k: torch.as_tensor(v) for k, v in batch.items()}).numpy()
    want = jax_recsys.pooled_history_embedding_bag(jcfg, jparams, jb, use_kernel=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_recsys.user_vector(jcfg, jparams, jb)), rtol=1e-5, atol=1e-5)
    assert not got[3].any()  # the empty history pools to zeros


def test_din_retrieval_scores_match_jax(din):
    jcfg, jparams, cfg, params, batch = din
    uv = np.random.default_rng(9).normal(size=(3, 36)).astype(np.float32)
    cand = np.arange(100, dtype=np.int32)
    got = recsys.retrieval_scores(cfg, params, torch.as_tensor(uv), torch.as_tensor(cand),
                                  torch.as_tensor(cand % 20))
    want = jax_recsys.retrieval_scores(jcfg, jparams, jnp.asarray(uv), jnp.asarray(cand), jnp.asarray(cand % 20))
    assert tuple(got.shape) == (3, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_din_init_shapes_match_jax():
    cfg = recsys.DinConfig(n_items=500, n_cats=20, seq_len=10)
    params = recsys.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    jparams = jax_recsys.init(jax_recsys.DinConfig(n_items=500, n_cats=20, seq_len=10), jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == jax.tree.map(lambda a: tuple(a.shape), jparams)


# ------------------------------------------------------------------- data
def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("which", ["lm_token_stream", "din_batch", "din_stream"])
def test_pipeline_batches_bit_equal(which):
    if which == "lm_token_stream":
        cfg = dict(vocab=300, seq_len=40, batch=3, seed=5)
        ours = pipeline.lm_token_stream(pipeline.LmDataConfig(**cfg))
        theirs = jax_pipeline.lm_token_stream(jax_pipeline.LmDataConfig(**cfg))
        for _ in range(3):
            _assert_same(next(ours), next(theirs))
    elif which == "din_batch":
        _assert_same(pipeline.din_batch(16, 12, 1000, 30, seed=3), jax_pipeline.din_batch(16, 12, 1000, 30, seed=3))
    else:
        ours, theirs = pipeline.din_stream(8, 6, 100, 5, seed=1), jax_pipeline.din_stream(8, 6, 100, 5, seed=1)
        for _ in range(3):
            _assert_same(next(ours), next(theirs))
