"""Architecture-config registry and dry-run cell builders (twin of ``repro.configs.base``).

Every architecture registers an :class:`ArchConfig` with
* the published full config (in the dry run only as ``meta`` tensors:
  shapes and dtypes, no storage),
* a reduced smoke run (``smoke(device=None)``, CUDA unless the caller
  passes another device; the tests run it on the CPU),
* per-shape :class:`DryRunSpec` builders returning ``(step_fn,
  abstract_args, in_specs)`` for ``python -m repro_torch.launch.dryrun``.

Cells are (arch × shape); a skipped cell carries its reason: ``long_500k``
is skipped for the five full-attention LM archs, as in the JAX package.

A spec's ``abstract_args`` are ``meta`` tensors with the JAX package's
shapes and dtypes (the whole arrays), and its ``in_specs`` the JAX layout,
by the port's rules (:mod:`repro_torch.distributed.sharding`). Its
``step_fn`` is a torch function of one rank's arguments, as
:func:`rank_args` cuts them from the whole ones. An LM cell runs the JAX
layout itself: each rank holds its shard of every leaf, and the step is
``transformer.loss_fn``/``forward``/``serve_step`` with the mesh
(vocabulary-parallel embedding and cross-entropy, tensor-parallel attention
and SwiGLU, expert-parallel routed experts, split-K decode). A DIN cell
runs with its tables whole along the model axis (its lookup is not
vocabulary parallel): its ``run_specs`` say so. A ``train`` step is a
loss and its gradients through ``torch.autograd`` (the trainer's
:func:`~repro_torch.train.loop.value_and_grad`: with a mesh every rank
holds the global loss and the gradients are summed over the batch axes),
then :func:`repro_torch.optim.adamw.update` with the clipping norm over
the shards (:func:`grad_norm`). A builder's mesh is a live
:class:`~repro_torch.launch.mesh.HostMesh` or the dry run's
:class:`~repro_torch.launch.mesh.MetaMesh`.

A GNN or MACE rank runs its step on its shard of the node and edge tables
as the specs cut them, the edge ids unchanged: on ``meta`` that gives the
shapes, FLOPs and collective bytes the dry run records; on real data over
more than one rank the edges would need the halo exchange
(:mod:`repro_torch.distributed.halo`), which no cell runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import sum_replicated
from repro_torch.models import gnn as gnn_m
from repro_torch.models import mace as mace_m
from repro_torch.models import recsys as recsys_m
from repro_torch.models import transformer as tf
from repro_torch.models.moe import MoeConfig
from repro_torch.optim import adamw
from repro_torch.train.loop import value_and_grad

PyTree = Any


@dataclasses.dataclass
class DryRunSpec:
    step_fn: Callable
    abstract_args: Tuple            # meta tensors, positional: the whole arguments
    in_specs: Tuple                 # matching spec tree (the JAX layout)
    kind: str                       # train | prefill | decode | serve | retrieval
    note: str = ""
    run_specs: Optional[Tuple] = None   # the placement the step runs under, where it is not in_specs


@dataclasses.dataclass
class ArchConfig:
    arch_id: str
    family: str                                     # lm | gnn | recsys
    shapes: Tuple[str, ...]
    skipped: Dict[str, str]                         # shape -> reason
    dryrun: Callable[[str, Any], DryRunSpec]        # (shape, mesh) -> spec
    smoke: Callable[..., Dict[str, float]]          # smoke(device=None): reduced run, returns metrics
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # The JAX dry run's layer-count probe corrects XLA's count of a scan
    # body, which it counts once. Eager torch runs every layer of a Python
    # loop and the FLOP counter sees each, so no arch has a probe here.
    probe: Optional[Callable[[str, Any, int], DryRunSpec]] = None
    probe_layers: int = 0


_REGISTRY: Dict[str, ArchConfig] = {}
_LOADED = False


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get(arch_id: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[arch_id]


def all_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def all_cells() -> List[Tuple[str, str]]:
    """Every runnable (arch, shape) cell."""
    _ensure_loaded()
    cells = []
    for a in all_archs():
        c = _REGISTRY[a]
        for s in c.shapes:
            if s not in c.skipped:
                cells.append((a, s))
    return cells


def skipped_cells() -> List[Tuple[str, str, str]]:
    _ensure_loaded()
    out = []
    for a in all_archs():
        c = _REGISTRY[a]
        for s, reason in c.skipped.items():
            out.append((a, s, reason))
    return out


def _ensure_loaded() -> None:
    # A flag, not "is the registry empty": importing one config module
    # (``from repro_torch.configs.din import FULL``) registers that arch alone.
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import (  # noqa: F401  (registration side effects)
        deepseek_coder_33b, deepseek_moe_16b, din, gcn_cora, granite_3_8b, graphsage_reddit, mace,
        meshgraphnet, qwen3_moe_30b_a3b, yi_34b,
    )
    _LOADED = True


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _data_mean(loss: torch.Tensor, mesh) -> torch.Tensor:
    """A rank's loss over its shard → the mean over the batch axes, held by
    every rank (the shards are equal)."""
    if mesh is None:
        return loss
    return sum_replicated(loss, mesh, shd.batch_axes(mesh)) / shd.data_shards(mesh)


def rank_args(spec: DryRunSpec, mesh) -> Tuple:
    """This rank's arguments of ``spec.step_fn``: ``spec.abstract_args`` cut
    by the specs the step runs under (``run_specs``, else ``in_specs``). On
    ``meta`` a cut allocates nothing."""
    def walk(a, s):
        if isinstance(a, dict):
            return {k: walk(v, s[k]) for k, v in a.items()}
        if isinstance(a, (tuple, list)):
            return type(a)(walk(v, sv) for v, sv in zip(a, s))
        return shd.shard_leaf(a, s, mesh)

    return walk(spec.abstract_args, spec.run_specs or spec.in_specs)


def grad_norm(grads: PyTree, mesh, specs: Optional[PyTree] = None) -> Optional[torch.Tensor]:
    """The whole gradient's norm, for :func:`~repro_torch.optim.adamw.update`'s
    clipping, where ``specs`` (the parameters' spec tree) split some leaf
    over more than one model rank: those leaves' squares are summed over the
    model axis, every other leaf (whole on each model rank) counted once.
    ``None`` where nothing is split (the update then computes the same
    norm)."""
    if mesh is None or specs is None or mesh.shape.get("model", 1) == 1:
        return None
    split = [i for i, s in enumerate(adamw.leaves(specs)) if shd.splits_over(s, "model")]
    if not split:
        return None
    squares = [torch.sum(torch.square(g.to(torch.float32))) for g in adamw.leaves(grads)]
    summed = mesh.all_reduce(torch.stack([squares[i] for i in split]), axis="model")
    for j, i in enumerate(split):
        squares[i] = summed[j]
    return torch.sqrt(sum(squares))


def train_step_fn(loss_f: Callable[[PyTree, Dict[str, torch.Tensor]], torch.Tensor], mesh=None,
                  opt_cfg: Optional[adamw.AdamWConfig] = None,
                  specs_of: Optional[Callable[[PyTree], PyTree]] = None) -> Callable:
    """``train_step(params, opt_state, batch) → (params, opt_state, loss)``:
    :func:`value_and_grad` of ``loss_f(params, batch)``, then one AdamW
    update (pure: new tensors, the inputs untouched). ``specs_of`` gives the
    parameters' spec tree where a mesh splits leaves over the model axis
    (the clipping's :func:`grad_norm`)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: loss_f(p, batch), params, mesh)
        specs = specs_of(grads) if specs_of is not None else None
        params, opt_state, _ = adamw.update(params, grads, opt_state, opt_cfg,
                                            grad_norm=grad_norm(grads, mesh, specs))
        return params, opt_state, loss

    return train_step


# ===========================================================================
# LM family builders
# ===========================================================================
LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256),
    "prefill_32k": dict(seq_len=32768, global_batch=32),
    "decode_32k": dict(seq_len=32768, global_batch=128),
    "long_500k": dict(seq_len=524288, global_batch=1),
}
LM_SKIP_LONG = (
    "pure full-attention arch (GQA): long_500k requires sub-quadratic "
    "attention per the assignment; skipped and documented in DESIGN.md §5"
)


def lm_train_step(cfg: tf.TransformerConfig, mesh=None, opt_cfg: Optional[adamw.AdamWConfig] = None) -> Callable:
    """The LM's train step: the JAX layout on a mesh (the parameters and
    the optimizer state this rank's shards by ``lm_param_specs``, the batch
    its data shard), the dense step on one device (``mesh`` None)."""
    return train_step_fn(lambda p, b: tf.loss_fn(cfg, p, b, mesh=mesh), mesh, opt_cfg,
                         specs_of=shd.lm_param_specs)


def lm_dryrun(
    cfg: tf.TransformerConfig, shape: str, mesh, n_layers_override: Optional[int] = None,
    opt_cfg: Optional[adamw.AdamWConfig] = None,
) -> DryRunSpec:
    """The LM cell ``shape`` of ``cfg`` (twin of the JAX ``lm_dryrun``). The
    embedding and head vocab is padded to a multiple of 128 (Megatron's
    padding: the vocab dimension must divide the model axis; ``meta`` keeps
    the published count). ``n_layers_override`` cuts the depth (the JAX dry
    run's probes; ``chip_smoke.py`` trains the qwen3-moe-30b-a3b cell at
    the depth one card holds), and ``opt_cfg`` replaces the train step's
    default ``AdamWConfig()`` (whose 100 warm-up steps move no bf16 weight
    in a few steps). Every step runs the JAX layout on the mesh; the
    prefill step gathers the last position's logits over the model axis,
    and decode returns the rank's vocabulary columns."""
    cfg = dataclasses.replace(cfg, vocab=-(-cfg.vocab // 128) * 128,
                              n_layers=n_layers_override or cfg.n_layers)
    params_abs = tf.init_abstract(cfg)
    pspecs = shd.lm_param_specs(params_abs)
    baxes = shd.batch_axes(mesh)
    spec = LM_SHAPES[shape]
    b, t = spec["global_batch"], spec["seq_len"]

    if shape == "train_4k":
        batch_abs = {"tokens": _meta((b, t), torch.int32), "labels": _meta((b, t), torch.int32)}
        bspecs = {"tokens": shd.spec(baxes, None), "labels": shd.spec(baxes, None)}
        return DryRunSpec(
            step_fn=lm_train_step(cfg, mesh, opt_cfg),
            abstract_args=(params_abs, adamw.init(params_abs), batch_abs),
            in_specs=(pspecs, shd.opt_state_specs(pspecs), bspecs),
            kind="train",
        )

    if shape == "prefill_32k":
        def prefill_step(params, tokens):
            logits, _ = tf.forward(cfg, params, tokens, mesh=mesh)
            return torch.cat(mesh.all_gather(logits[:, -1, :].contiguous(), axis="model"), dim=-1)

        return DryRunSpec(
            step_fn=prefill_step,
            abstract_args=(params_abs, _meta((b, t), torch.int32)),
            in_specs=(pspecs, shd.spec(baxes, None)),
            kind="prefill",
        )

    if shape in ("decode_32k", "long_500k"):
        cspec = shd.kv_cache_spec(mesh)

        def decode_step(params, token, cache):
            return tf.serve_step(cfg, params, token, cache, t - 1, mesh=mesh)

        return DryRunSpec(
            step_fn=decode_step,
            abstract_args=(params_abs, _meta((b,), torch.int32), tf.init_kv_cache(cfg, b, t, device="meta")),
            in_specs=(pspecs, shd.spec(baxes), (cspec, cspec)),
            kind="decode",
        )
    raise KeyError(shape)


def lm_smoke(cfg_full: tf.TransformerConfig, moe: Optional[MoeConfig] = None, device=None,
             params: Optional[PyTree] = None, tokens: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Reduced config (2 layers, d_model 64): one loss, its gradients and an
    AdamW update, the forward on the new parameters and one decode step,
    all finite. ``params`` and ``tokens`` (``[2, 16]``) default to draws on
    ``device``; the tests pass the JAX smoke's."""
    dev = resolve_device(device)
    small_moe = None
    if moe is not None:
        small_moe = MoeConfig(
            n_experts=min(moe.n_experts, 8), top_k=min(moe.top_k, 2),
            n_shared=min(moe.n_shared, 1), d_ff=64,
        )
    cfg = tf.TransformerConfig(
        name=cfg_full.name + "_smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=max(1, 4 * cfg_full.n_kv_heads // cfg_full.n_heads),
        d_ff=128, vocab=211, moe=small_moe,
    )
    if params is None:
        params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator(device=dev).manual_seed(1),
                               device=dev)
    batch = {"tokens": tokens, "labels": tokens}
    loss, grads = value_and_grad(lambda p: tf.loss_fn(cfg, p, batch), params)
    params2, _, om = adamw.update(params, grads, adamw.init(params), adamw.AdamWConfig())
    with torch.no_grad():
        logits, _ = tf.forward(cfg, params2, tokens)
        cache = tf.init_kv_cache(cfg, 2, 32, device=dev)
        lg, _ = tf.serve_step(cfg, params2, tokens[:, 0], cache, 0)
    if logits.shape != (2, 16, cfg.vocab) or lg.shape != (2, cfg.vocab):
        raise RuntimeError(f"{cfg.name}: wrong shapes {tuple(logits.shape)}, {tuple(lg.shape)}")
    if not all(bool(torch.isfinite(x).all()) for x in (loss, logits, lg)):
        raise RuntimeError(f"{cfg.name}: non-finite loss or logits")
    return {"loss": float(loss), "grad_norm": float(om["grad_norm"])}


# ===========================================================================
# GNN family builders
# ===========================================================================
GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2_708, n_edges=10_556, d_feat=1_433),
    "minibatch_lg": dict(
        n_nodes=232_965, n_edges=114_615_892, batch_nodes=1_024, fanout=(15, 10), d_feat=602
    ),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16),
}


def _r32(x: int) -> int:
    """Round up to a multiple of 32 (pod·data shard divisibility; padding
    nodes/edges mirrors what the partition-aware layout does on hardware)."""
    return -(-x // 32) * 32


def _gnn_shape_dims(shape: str) -> Dict[str, int]:
    s = GNN_SHAPES[shape]
    if shape == "molecule":
        n = _r32(s["n_nodes"] * s["batch"])
        e = _r32(s["n_edges"] * s["batch"] * 2)  # symmetrized
        return dict(n_nodes=n, n_edges=e, d_feat=s["d_feat"], n_graphs=s["batch"])
    if shape == "minibatch_lg":
        # layered sample sizes: batch ← fanout[1] ← fanout[0]
        n2 = _r32(s["batch_nodes"])
        n1 = _r32(n2 * (s["fanout"][1] + 1))
        n0 = _r32(n1 * (s["fanout"][0] + 1))
        return dict(
            n_nodes=n0, n_edges=_r32(2 * (n2 * s["fanout"][1] + n1 * s["fanout"][0])),
            d_feat=s["d_feat"], n2=n2, n1=n1, n0=n0, fanout=s["fanout"],
        )
    return dict(
        n_nodes=_r32(s["n_nodes"]), n_edges=_r32(2 * s["n_edges"]),
        d_feat=s["d_feat"], n_graphs=1,
    )


def gnn_dryrun(
    kind: str, gcfg_builder, shape: str, mesh, n_layers_override: Optional[int] = None
) -> DryRunSpec:
    """Generic GNN/MACE train-step cell over the shape's graph dims."""
    dims = _gnn_shape_dims(shape)
    if n_layers_override is not None:
        inner = gcfg_builder

        def gcfg_builder(d):  # noqa: F811 — a cut-depth variant
            return dataclasses.replace(inner(d), n_layers=n_layers_override)
    baxes = shd.batch_axes(mesh)
    n, e, d_feat = dims["n_nodes"], dims["n_edges"], dims["d_feat"]
    f32, i32 = torch.float32, torch.int32

    if kind == "mace":
        mcfg: mace_m.MaceConfig = gcfg_builder(dims)
        params_abs = mace_m.init(mcfg, torch.Generator(), device="meta")
        n_graphs = dims.get("n_graphs", 1) or 1
        batch_abs = {
            "species": _meta((n,), i32), "pos": _meta((n, 3), f32),
            "senders": _meta((e,), i32), "receivers": _meta((e,), i32),
            "mol_id": _meta((n,), i32), "energy": _meta((max(n_graphs, 1),), f32),
        }
        bspecs = {
            "species": shd.spec(baxes), "pos": shd.spec(baxes, None),
            "senders": shd.spec(baxes), "receivers": shd.spec(baxes),
            "mol_id": shd.spec(baxes), "energy": (),
        }
        pspecs = shd.replicated_specs(params_abs)

        def mace_loss(p, batch):
            energy, _ = mace_m.forward(mcfg, p, batch["species"], batch["pos"], batch["senders"],
                                       batch["receivers"], batch["mol_id"], n_graphs)
            if mesh is not None:  # a molecule's atoms may lie on several ranks
                energy = sum_replicated(energy, mesh, baxes)
            return torch.mean((energy - batch["energy"]) ** 2)

        return DryRunSpec(
            step_fn=train_step_fn(mace_loss, mesh),
            abstract_args=(params_abs, adamw.init(params_abs), batch_abs),
            in_specs=(pspecs, shd.opt_state_specs(pspecs), bspecs),
            kind="train",
        )

    gcfg: gnn_m.GnnConfig = gcfg_builder(dims)
    params_abs = gnn_m.init(gcfg, torch.Generator(), device="meta")
    pspecs = shd.replicated_specs(params_abs)

    if kind == "sage" and shape == "minibatch_lg":
        n2, n1, n0 = dims["n2"], dims["n1"], dims["n0"]
        f0, f1 = dims["fanout"]
        batch_abs = {
            "feats": _meta((n0, d_feat), f32),
            "nbrs0": _meta((n1, f0), i32), "mask0": _meta((n1, f0), f32),
            "nbrs1": _meta((n2, f1), i32), "mask1": _meta((n2, f1), f32),
            "labels": _meta((n2,), i32),
        }
        bspecs = {
            "feats": shd.spec(baxes, None), "nbrs0": shd.spec(baxes, None), "mask0": shd.spec(baxes, None),
            "nbrs1": shd.spec(baxes, None), "mask1": shd.spec(baxes, None), "labels": shd.spec(baxes),
        }

        def sampled_loss(p, batch):
            # each block's targets: this rank's rows of it
            out = gnn_m.sage_forward_sampled(
                gcfg, p, [batch["feats"]], [batch["nbrs0"], batch["nbrs1"]],
                [batch["mask0"], batch["mask1"]], [batch["nbrs0"].shape[0], batch["nbrs1"].shape[0]],
            )
            return _data_mean(gnn_m.node_classification_loss(out, batch["labels"]), mesh)

        return DryRunSpec(train_step_fn(sampled_loss, mesh),
                          (params_abs, adamw.init(params_abs), batch_abs),
                          (pspecs, shd.opt_state_specs(pspecs), bspecs), "train")

    # full-graph (or sampled-subgraph) edge-list formulation
    batch_abs = {
        "x": _meta((n, d_feat), f32), "senders": _meta((e,), i32),
        "receivers": _meta((e,), i32), "labels": _meta((n,), i32),
    }
    bspecs = {"x": shd.spec(baxes, None), "senders": shd.spec(baxes), "receivers": shd.spec(baxes),
              "labels": shd.spec(baxes)}
    if kind == "meshgraphnet":
        batch_abs["edge_feat"] = _meta((e, gcfg.d_edge_in), f32)
        bspecs["edge_feat"] = shd.spec(baxes, None)

    def graph_loss(p, batch):
        if kind == "gcn":
            out = gnn_m.gcn_forward(gcfg, p, batch["x"], batch["senders"], batch["receivers"])
        elif kind == "sage":
            out = gnn_m.sage_forward_full(gcfg, p, batch["x"], batch["senders"], batch["receivers"])
        else:  # meshgraphnet
            out = gnn_m.mgn_forward(gcfg, p, batch["x"], batch["edge_feat"], batch["senders"],
                                    batch["receivers"])
            return _data_mean(torch.mean((out - 0.0) ** 2), mesh)  # regression target stub = 0
        return _data_mean(gnn_m.node_classification_loss(out, batch["labels"]), mesh)

    return DryRunSpec(train_step_fn(graph_loss, mesh), (params_abs, adamw.init(params_abs), batch_abs),
                      (pspecs, shd.opt_state_specs(pspecs), bspecs), "train")


# ===========================================================================
# RecSys (DIN) builders
# ===========================================================================
DIN_SHAPES = {
    "train_batch": dict(batch=65_536),
    "serve_p99": dict(batch=512),
    "serve_bulk": dict(batch=262_144),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000),
}


def din_batch_abs(cfg: recsys_m.DinConfig, b: int, with_label: bool = True):
    d = {
        "hist_items": _meta((b, cfg.seq_len), torch.int32),
        "hist_cats": _meta((b, cfg.seq_len), torch.int32),
        "hist_mask": _meta((b, cfg.seq_len), torch.float32),
        "target_item": _meta((b,), torch.int32),
        "target_cat": _meta((b,), torch.int32),
    }
    if with_label:
        d["label"] = _meta((b,), torch.int32)
    return d


def din_batch_specs(mesh, with_label: bool = True):
    baxes = shd.batch_axes(mesh)
    d = {
        "hist_items": shd.spec(baxes, None), "hist_cats": shd.spec(baxes, None),
        "hist_mask": shd.spec(baxes, None), "target_item": shd.spec(baxes), "target_cat": shd.spec(baxes),
    }
    if with_label:
        d["label"] = shd.spec(baxes)
    return d


def din_dryrun(cfg: recsys_m.DinConfig, shape: str, mesh) -> DryRunSpec:
    params_abs = recsys_m.init(cfg, torch.Generator(), device="meta")
    pspecs = shd.din_param_specs(params_abs)
    whole = shd.replicated_specs(params_abs)  # as run: the tables whole along the model axis
    baxes = shd.batch_axes(mesh)
    s = DIN_SHAPES[shape]
    b = s["batch"]

    if shape == "train_batch":
        return DryRunSpec(
            train_step_fn(lambda p, batch: _data_mean(recsys_m.bce_loss(cfg, p, batch), mesh), mesh),
            (params_abs, adamw.init(params_abs), din_batch_abs(cfg, b)),
            (pspecs, shd.opt_state_specs(pspecs), din_batch_specs(mesh)),
            "train",
            run_specs=(whole, shd.opt_state_specs(whole), din_batch_specs(mesh)),
        )

    if shape in ("serve_p99", "serve_bulk"):
        def serve_step(params, batch):
            return recsys_m.forward(cfg, params, batch)

        return DryRunSpec(
            serve_step,
            (params_abs, din_batch_abs(cfg, b, with_label=False)),
            (pspecs, din_batch_specs(mesh, with_label=False)),
            "serve",
            run_specs=(whole, din_batch_specs(mesh, with_label=False)),
        )

    # retrieval_cand: one user against 1M candidates; the user tower
    # replicates (batch 1 cannot shard), candidate scoring shards over the
    # batch axes.
    nc = s["n_candidates"]

    def retrieval_step(params, batch, cand_items, cand_cats):
        uv = recsys_m.user_vector(cfg, params, batch)
        return recsys_m.retrieval_scores(cfg, params, uv, cand_items, cand_cats)

    replicated_batch = {k: () for k in din_batch_abs(cfg, b, with_label=False)}
    return DryRunSpec(
        retrieval_step,
        (params_abs, din_batch_abs(cfg, b, with_label=False),
         _meta((nc,), torch.int32), _meta((nc,), torch.int32)),
        (pspecs, replicated_batch, shd.spec(baxes), shd.spec(baxes)),
        "retrieval",
        run_specs=(whole, replicated_batch, shd.spec(baxes), shd.spec(baxes)),
    )


# ===========================================================================
# Analytic MODEL_FLOPS per cell (§Roofline "useful compute")
# ===========================================================================
def analytic_model_flops(arch: str, shape: str, n_devices: int) -> Optional[float]:
    """Hand-derived useful FLOPs per device for non-LM cells.

    LM cells use 6·N_active·D (``launch/dryrun.py``, as the JAX package's
    ``benchmarks/roofline.py``); these formulas cover the GNN and recsys
    families (matmul + edge-reduce terms, train = 3× forward for backward,
    optimizer negligible).
    """
    cfg = get(arch)
    if cfg.family == "lm":
        return None  # handled via params meta
    if cfg.family == "gnn":
        dims = _gnn_shape_dims(shape)
        n, e, f = dims["n_nodes"], dims["n_edges"], dims["d_feat"]
        if arch == "gcn-cora":
            d, c = 16, 7
            fwd = 2 * n * f * d + 2 * e * d + 2 * n * d * c + 2 * e * c
        elif arch == "graphsage-reddit":
            d, c = 128, 41
            if shape == "minibatch_lg":
                # sampled forward: layer i transforms n_i rows, not n_0
                n1, n2 = dims["n1"], dims["n2"]
                f0, f1 = dims["fanout"]
                fwd = (
                    n1 * f0 * f + 4 * n1 * f * d      # hop-1 gather-mean + 2 matmuls
                    + n2 * f1 * d + 4 * n2 * d * c    # hop-2
                )
            else:
                fwd = 4 * n * f * d + 2 * e * f + 4 * n * d * c + 2 * e * d
        elif arch == "meshgraphnet":
            d, L = 128, 15
            per_layer = 2 * e * (3 * d * d + d * d) + 2 * n * (2 * d * d + d * d)
            fwd = L * per_layer + 2 * n * (dims["d_feat"] * d + d * d) + 2 * e * (4 * d + d * d)
        elif arch == "mace":
            c, L, nrbf = 128, 2, 8
            per_layer = (
                2 * e * nrbf * c * 3          # radial MLPs
                + e * c * 60                  # irrep products (s,v,T messages)
                + 2 * n * (3 * c * c * 1 + 3 * c * c * 3 + 2 * c * c * 9)  # mixes
            )
            fwd = L * per_layer + 2 * n * c * c
        else:
            return None
        return 3.0 * fwd / n_devices  # train step ≈ 3× forward
    if cfg.family == "recsys":
        s = DIN_SHAPES[shape]
        b = s["batch"]
        d2 = 2 * 18                      # item‖cat embedding
        seq = 100
        attn = 2 * b * seq * (4 * d2 * 80 + 80 * 40 + 40)
        mlp = 2 * b * (2 * d2 * 200 + 200 * 80 + 80)
        fwd = attn + mlp
        if shape == "train_batch":
            return 3.0 * fwd / n_devices
        if shape == "retrieval_cand":
            return (2 * b * s["n_candidates"] * d2 + fwd / seq) / n_devices
        return fwd / n_devices
    return None
