"""Port parity for the MoE layer, the MoE transformer, the four remaining LM
configs and the DiDiC expert placement, against the JAX package on the CPU.

Inputs come from numpy seeds; weights are drawn by the JAX package and
carried across as numpy. Bars: ``moe_fwd``'s output and aux loss within
1e-5 in float32 (capacity drops, the shared expert alone and tied router
logits included), the top-k choices equal to ``jax.lax.top_k``'s, bfloat16
within 0.0625 (four bfloat16 steps at the largest output, the bar of
``test_torch_models.py``'s bfloat16 forward); the MoE transformer's
logits, loss, ``serve_step`` logits and caches within 1e-4, as the dense
tests; shapes and parameter counts of the four full configs equal, drawn on
the ``meta`` device; the expert co-activation graph, the co-location
fraction and the expert permutation bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_coder_33b as jax_deepseek_coder
from repro.configs import deepseek_moe_16b as jax_deepseek_moe
from repro.configs import qwen3_moe_30b_a3b as jax_qwen3
from repro.configs import yi_34b as jax_yi
from repro.distributed import expert_placement as jax_placement
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch import convert
from repro_torch.configs import deepseek_coder_33b, deepseek_moe_16b, qwen3_moe_30b_a3b, yi_34b
from repro_torch.distributed import expert_placement
from repro_torch.models import moe
from repro_torch.models import transformer as tf

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

D = 64
MOE = dict(n_experts=8, top_k=2, d_ff=32)

#: name → (MoeConfig fields, x shape, experts whose router column is copied
#: from expert 1, so that their logits tie with expert 1's)
CASES = {
    "routed": (MOE, (2, 16, D), ()),
    "drops": (dict(MOE, capacity_factor=0.25), (4, 32, D), ()),
    "shared_and_routed": (dict(MOE, n_shared=2), (2, 24, D), ()),
    "shared_only": (dict(n_experts=4, top_k=1, n_shared=1, d_ff=16, capacity_factor=1e-9), (4, 128, D), ()),
    "tied_logits": (dict(MOE, top_k=3), (2, 32, D), (3, 6)),
}


def _case(name, dtype=np.float32):
    fields, shape, tied = CASES[name]
    jcfg, cfg = jax_moe.MoeConfig(**fields), moe.MoeConfig(**fields)
    p = jax.tree.map(np.array, jax_moe.moe_init(jax.random.PRNGKey(0), D, jcfg))
    for e in tied:
        p["router"][:, e] = p["router"][:, 1]
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    if dtype != np.float32:
        p = {k: (v if k == "router" else jax.tree.map(lambda a: a.astype(dtype), v)) for k, v in p.items()}
        x = x.astype(dtype)
    return jcfg, cfg, p, x


def _torch(tree):
    return convert._tree(tree, torch.device("cpu"))


@pytest.mark.parametrize("name", list(CASES))
def test_moe_fwd_matches_jax(name):
    jcfg, cfg, p, x = _case(name)
    jy, jaux = jax_moe.moe_fwd(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    y, aux = moe.moe_fwd(_torch(p), torch.as_tensor(x), cfg)
    assert tuple(y.shape) == x.shape and y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_route_matches_jax_top_k(name):
    jcfg, cfg, p, x = _case(name)
    xf = x.reshape(-1, D)
    probs, gate_vals, idx, _ = moe.route(_torch(p), torch.as_tensor(xf), cfg)
    jprobs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(p["router"]), axis=-1)
    jgate, jidx = jax.lax.top_k(jprobs, jcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gate_vals.sum(-1).numpy(), 1.0, rtol=1e-6)
    counts = np.bincount(idx.numpy().ravel(), minlength=cfg.n_experts)
    cap = moe.capacity(xf.shape[0], cfg)
    if name in ("drops", "shared_only"):
        assert counts.max() > cap  # the case really drops assignments
    if name == "tied_logits":
        ties = np.asarray(jprobs)[:, [1, 3, 6]]
        assert (ties == ties[:, :1]).all()
        tied_picks = np.isin(np.asarray(jidx), [1, 3, 6]).sum(axis=1)
        assert (tied_picks >= 2).any()  # some tokens pick two tied experts: the order decides


def test_shared_expert_alone_where_everything_drops():
    """capacity_factor 1e-9 with N ≫ 8·E: dropped tokens get exactly the
    shared expert's output, kept ones more (the JAX package's test)."""
    _, cfg, p, x = _case("shared_only")
    y, _ = moe.moe_fwd(_torch(p), torch.as_tensor(x), cfg)
    from repro_torch.models.layers import swiglu
    shared = swiglu(_torch(p)["shared"], torch.as_tensor(x).reshape(-1, D)).reshape(x.shape)
    diff = (y - shared).abs().amax(dim=-1).reshape(-1)
    frac = float((diff < 1e-5).float().mean())
    assert 0.8 < frac < 1.0, frac


@pytest.mark.parametrize("name", ["routed", "drops", "shared_and_routed"])
def test_moe_fwd_bf16_tracks_jax(name):
    jcfg, cfg, p, x = _case(name, dtype=jnp.bfloat16)
    jy, jaux = jax_moe.moe_fwd(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    tp = _torch(p)
    assert tp["w_gate"].dtype == torch.bfloat16 and tp["router"].dtype == torch.float32
    y, aux = moe.moe_fwd(tp, _torch({"x": x})["x"], cfg)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, dtype=np.float32), rtol=0, atol=0.0625)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- MoE transformer
LMS = {
    # deepseek-moe's shape: shared experts, kv heads = q heads
    "shared": dict(n_layers=2, d_model=D, n_heads=4, n_kv_heads=4, d_ff=32, vocab=128,
                   moe_fields=dict(MOE, n_shared=1)),
    # qwen3's shape: d_head (32) ≠ d_model / n_heads (16), groups of 4, no shared expert
    "wide_heads": dict(n_layers=2, d_model=D, n_heads=4, n_kv_heads=1, d_head=32, d_ff=32, vocab=128,
                       moe_fields=dict(MOE, capacity_factor=0.5)),
}


def _lm(name):
    fields = dict(LMS[name])
    mf = fields.pop("moe_fields")
    jcfg = jax_tf.TransformerConfig(**fields, moe=jax_moe.MoeConfig(**mf), use_flash_kernel=True)
    jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = tf.TransformerConfig(**fields, moe=moe.MoeConfig(**mf))
    params = convert.transformer_params_from_arrays(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("name", list(LMS))
def test_moe_transformer_forward_loss_and_decode_match_jax(name):
    jcfg, jparams, cfg, params = _lm(name)
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    toks = np.random.default_rng(4).integers(0, 128, size=(2, 48)).astype(np.int32)
    jlogits, jaux = jax_tf.forward(jcfg, jparams, jnp.asarray(toks))
    logits, aux = tf.forward(cfg, params, torch.as_tensor(toks))
    assert tuple(logits.shape) == (2, 48, 128) and float(aux) > 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jloss = jax_tf.loss_fn(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = tf.loss_fn(cfg, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, atol=1e-4)

    jcache = jax_tf.init_kv_cache(jcfg, 2, 12)
    cache = tf.init_kv_cache(cfg, 2, 12, device="cpu")
    for t in range(8):
        jstep, jcache = jax_tf.serve_step(jcfg, jparams, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        step, cache = tf.serve_step(cfg, params, torch.as_tensor(toks[:, t]), cache, t)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=1e-4, atol=1e-4)
    for got, want in zip(cache, jcache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_convert_checks_moe_keys():
    _, jparams, _, _ = _lm("shared")
    tree = jax.tree.map(np.asarray, jparams)
    del tree["layers"]["moe"]["router"]
    with pytest.raises(ValueError, match=r"layers\.moe lacks \['router'\]"):
        convert.transformer_params_from_arrays(tree, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    del tree["layers"]["moe"]["shared"]["w_up"]
    with pytest.raises(ValueError, match=r"layers\.moe\.shared lacks \['w_up'\]"):
        convert.transformer_params_from_arrays(tree, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    del tree["layers"]["moe"]
    with pytest.raises(ValueError, match=r"layers lacks \['ffn'\]"):
        convert.transformer_params_from_arrays(tree, device="cpu")


def test_moe_init_params_draws_the_counted_parameters():
    fields = dict(LMS["shared"])
    cfg = tf.TransformerConfig(**{k: v for k, v in fields.items() if k != "moe_fields"},
                               moe=moe.MoeConfig(**fields["moe_fields"]))
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = torch.utils._pytree.tree_leaves(params)
    assert sum(t.numel() for t in leaves) == cfg.param_count()
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    assert all(torch.isfinite(t).all() for t in leaves)


FULL = {
    "yi-34b": (yi_34b.FULL, jax_yi.FULL),
    "deepseek-coder-33b": (deepseek_coder_33b.FULL, jax_deepseek_coder.FULL),
    "deepseek-moe-16b": (deepseek_moe_16b.FULL, jax_deepseek_moe.FULL),
    "qwen3-moe-30b-a3b": (qwen3_moe_30b_a3b.FULL, jax_qwen3.FULL),
}


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


@pytest.mark.parametrize("arch", list(FULL))
def test_full_config_shapes_and_counts_match_jax(arch):
    cfg, jcfg = FULL[arch]
    assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    params = tf.init_abstract(cfg)
    leaves = torch.utils._pytree.tree_leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jax_tf.init_abstract(jcfg))
    assert _shapes(params) == jshapes
    assert cfg.param_count() == jcfg.param_count() == sum(t.numel() for t in leaves)
    assert cfg.active_param_count() == jcfg.active_param_count()
    if arch.startswith(("deepseek-moe", "qwen3")):
        assert cfg.moe == moe.MoeConfig(**vars(jcfg.moe))
        assert cfg.active_param_count() < cfg.param_count() // 5
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab) == (
        jcfg.n_layers, jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim, jcfg.d_ff, jcfg.vocab)


# ------------------------------------------------------- expert placement
def _routing():
    """The JAX package's ``TestExpertPlacement`` data: 16 experts whose
    blocks of 4 co-fire, 4,000 tokens, top-2."""
    rng = np.random.default_rng(0)
    n_experts, n_groups, k, tokens = 16, 4, 2, 4000
    base = rng.integers(0, n_groups, size=tokens)
    expert_idx = np.stack([4 * base + rng.integers(0, 4, size=tokens) for _ in range(k)], axis=1)
    return expert_idx, n_experts, n_groups


def test_coactivation_graph_bit_equal():
    expert_idx, n_experts, _ = _routing()
    g = expert_placement.coactivation_graph(expert_idx, n_experts)
    jg = jax_placement.coactivation_graph(expert_idx, n_experts)
    assert g.n_nodes == jg.n_nodes and g.name == jg.name
    for field in ("senders", "receivers", "edge_weight"):
        a, b = getattr(g, field), getattr(jg, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_co_location_and_permutation_bit_equal_given_groups():
    expert_idx, n_experts, n_groups = _routing()
    jgroups = jax_placement.didic_expert_groups(
        jax_placement.coactivation_graph(expert_idx, n_experts), n_groups, seed=0)
    uneven = np.array([0] * 7 + [1] * 5 + [2] * 3 + [3] * 1, dtype=np.int32)  # exercises the rebalance
    for groups in (np.asarray(jgroups), uneven, np.arange(n_experts) % n_groups):
        assert expert_placement.co_location_fraction(expert_idx, groups) == \
            jax_placement.co_location_fraction(expert_idx, groups)
        perm = expert_placement.expert_permutation(groups, n_groups)
        jperm = jax_placement.expert_permutation(groups, n_groups)
        assert perm.dtype == jperm.dtype
        np.testing.assert_array_equal(perm, jperm)
        assert sorted(perm.tolist()) == list(range(n_experts))


def test_port_didic_colocates_correlated_experts():
    expert_idx, n_experts, n_groups = _routing()
    g = expert_placement.coactivation_graph(expert_idx, n_experts)
    groups = expert_placement.didic_expert_groups(g, n_groups, seed=0, device="cpu")
    frac_didic = expert_placement.co_location_fraction(expert_idx, groups)
    frac_naive = expert_placement.co_location_fraction(expert_idx, np.arange(n_experts) % n_groups)
    assert frac_didic > frac_naive + 0.3, (frac_didic, frac_naive)
    perm = expert_placement.expert_permutation(groups, n_groups)
    assert sorted(perm.tolist()) == list(range(n_experts))


def test_placement_from_the_router():
    """The loop as ``chip_smoke.py`` runs it: the router's own top-k choices
    → co-activation graph → DiDiC groups → a balanced permutation."""
    _, cfg, p, x = _case("routed")
    _, _, idx, _ = moe.route(_torch(p), torch.as_tensor(x.reshape(-1, D)), cfg)
    idx = idx.numpy()
    g = expert_placement.coactivation_graph(idx, cfg.n_experts)
    assert g.n_edges == int((idx[:, 0] != idx[:, 1]).sum())
    groups = expert_placement.didic_expert_groups(g, 2, seed=0, device="cpu")
    perm = expert_placement.expert_permutation(groups, 2)
    assert sorted(perm.tolist()) == list(range(cfg.n_experts))
    assert 0.0 <= expert_placement.co_location_fraction(idx, groups) <= 1.0
