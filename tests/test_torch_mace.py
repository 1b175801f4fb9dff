"""Port parity for MACE: the radial basis, the l=2 product, the forward,
its invariances, one step's gradients and the launcher's trainer, against
the JAX package on the CPU.

Inputs come from numpy seeds; weights are drawn by the JAX package and
carried across as numpy (``repro_torch.convert``). Bars, each with its
reason:

* ``bessel_rbf`` and ``_outer_traceless``: within 1e-6 (elementwise float32
  ops);
* the forward: energies and scalars within 1e-5, relative and absolute
  (segment sums in another order, products through two layers);
* rotation and translation invariance: as ``tests/test_models.py``
  checks the JAX model (``rtol=1e-4, atol=1e-5``);
* one step's gradients against ``jax.grad``: every leaf within 1e-5 of its
  largest entry; the last layer's ``mix_v`` and ``mix_t``, which reach no
  output, exactly zero in both;
* the trainer against the JAX trainer at the launcher's config: losses and
  gradient norms within 1e-5 relative over the first 5 steps, all 10
  within ``DRIFT_RTOL``. At lr 5e-3 the launcher's MACE overshoots (its
  loss goes 68.7 → 1.48 → 4.27 by step 5), and each step multiplies a
  difference of rounding about tenfold: the two packages part by 1.7e-5 at
  step 6 and 2.3e-3 at step 9 (measured), and either float32 run parts
  from a float64 run of the port by more than that, so no float32 run can
  be held to 1e-5 there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import mace as jax_mace_config
from repro.graphs import datasets as jax_datasets
from repro.graphs import generators as jax_generators
from repro.models import mace as jax_mace
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainerConfig as JaxTrainerConfig
from repro_torch import convert
from repro_torch.configs import mace as mace_config
from repro_torch.launch import train as launch_train
from repro_torch.models import mace
from repro_torch.optim import adamw
from repro_torch.train.loop import Trainer, TrainerConfig

torch.set_num_threads(1)

TOL = 1e-5
GRAD_REL = 1e-5
LOSS_RTOL = 1e-5
#: the launcher trainer's bar after the first ``EXACT_STEPS`` (module docstring)
DRIFT_RTOL = 1e-2
EXACT_STEPS = 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _case(n_mols=3, atoms=8, d_hidden=8, n_layers=2, seed=0):
    mol = jax_generators.molecule_batch(n_mols=n_mols, atoms_per_mol=atoms, seed=seed)
    fields = dict(d_hidden=d_hidden, n_layers=n_layers)
    jcfg, cfg = jax_mace.MaceConfig(**fields), mace.MaceConfig(**fields)
    jparams = jax_mace.init(jcfg, jax.random.PRNGKey(seed))
    params = convert.mace_params_from_arrays(_np(jparams), n_layers, device="cpu")
    arrays = [mol.node_attrs["species"], mol.node_attrs["pos"], mol.senders, mol.receivers, mol.node_attrs["mol_id"]]
    return jcfg, cfg, jparams, params, arrays, n_mols


def _jax_args(arrays, n_mols):
    return tuple(jnp.asarray(a) for a in arrays) + (n_mols,)


def _port_args(arrays, n_mols):
    return tuple(torch.as_tensor(a) for a in arrays) + (n_mols,)


def test_bessel_rbf_matches_jax():
    r = np.concatenate([[0.0, 1e-7], np.random.default_rng(0).uniform(0, 3, size=100)]).astype(np.float32)
    got = mace.bessel_rbf(torch.as_tensor(r), 8, 2.0).numpy()
    want = np.asarray(jax_mace.bessel_rbf(jnp.asarray(r), 8, 2.0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[r >= 2.0] == 0)


def test_outer_traceless_matches_jax():
    v = np.random.default_rng(1).normal(size=(5, 4, 3)).astype(np.float32)
    got = mace._outer_traceless(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_mace._outer_traceless(jnp.asarray(v))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.trace(got, axis1=-2, axis2=-1), 0, atol=1e-5)
    np.testing.assert_allclose(got, np.swapaxes(got, -1, -2), atol=0)


@pytest.mark.parametrize("d_hidden,n_layers,n_mols,atoms", [(8, 2, 3, 8), (16, 1, 4, 10), (12, 3, 2, 30)])
def test_forward_matches_jax(d_hidden, n_layers, n_mols, atoms):
    jcfg, cfg, jparams, params, arrays, n = _case(n_mols, atoms, d_hidden, n_layers, seed=n_layers)
    je, js = jax_mace.forward(jcfg, jparams, *_jax_args(arrays, n))
    e, s = mace.forward(cfg, params, *_port_args(arrays, n))
    assert e.shape == (n,) and s.shape == (n * atoms, d_hidden)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=TOL, atol=TOL)


def _rotation():
    q, _ = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return torch.as_tensor(q.astype(np.float32))


def test_rotation_and_translation_invariance():
    _, cfg, _, params, arrays, n = _case()
    args = _port_args(arrays, n)
    e1, _ = mace.forward(cfg, params, *args)
    e2, _ = mace.forward(cfg, params, args[0], args[1] @ _rotation(), *args[2:])
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-5)
    e3, _ = mace.forward(cfg, params, args[0], args[1] + torch.tensor([1.3, -0.7, 2.1]), *args[2:])
    np.testing.assert_allclose(e1.numpy(), e3.numpy(), rtol=1e-4, atol=1e-5)


def test_forces_finite():
    _, cfg, _, params, arrays, n = _case()
    args = _port_args(arrays, n)
    pos = args[1].clone().requires_grad_(True)
    forces, = torch.autograd.grad(mace.forward(cfg, params, args[0], pos, *args[2:])[0].sum(), pos)
    assert bool(torch.isfinite(forces).all())


def test_init_shapes_equal_jax_init():
    cfg = dict(d_hidden=16, n_layers=3, n_rbf=6, n_species=5)
    jparams = jax_mace.init(jax_mace.MaceConfig(**cfg), jax.random.PRNGKey(0))
    params = mace.init(mace.MaceConfig(**cfg), torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in _flat(params).items()} == {k: v.shape for k, v in _flat(jparams).items()}
    with pytest.raises(ValueError, match="MACE pytree of 2 layers"):
        convert.mace_params_from_arrays(_np(jparams), 2, device="cpu")


UNUSED = ("layer1/mix_t", "layer1/mix_v")


def test_gradients_match_jax_grad_and_last_mixers_get_zero():
    """Through the trainer's own gradient function: the C1 repair gives the
    leaves the loss does not reach a zero gradient, as ``jax.grad`` does."""
    jcfg, cfg, jparams, params, arrays, n = _case(n_mols=4, atoms=10, d_hidden=16)
    target = np.random.default_rng(2).normal(size=n).astype(np.float32)
    jargs = _jax_args(arrays, n)
    jl, jg = jax.value_and_grad(lambda p: jnp.mean((jax_mace.forward(jcfg, p, *jargs)[0] - target) ** 2))(jparams)
    batch = {k: torch.as_tensor(a) for k, a in zip(("species", "pos", "senders", "receivers", "mol_id"), arrays)}
    batch["target"] = torch.as_tensor(target)
    tr = Trainer(lambda p, b: launch_train.gnn_loss(cfg, p, b), params, adamw.AdamWConfig(),
                 TrainerConfig(total_steps=1))
    loss, grads = tr._one_grad(params, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=TOL)
    got, want = _flat(grads), _flat(_np(jg))
    assert sorted(got) == sorted(want)
    for key in UNUSED:
        assert not np.any(want[key]) and not bool(got[key].any()), key
    for key in sorted(set(want) - set(UNUSED)):
        scale = max(float(np.abs(want[key]).max()), 1e-30)
        gap = float(np.abs(got[key].numpy().astype(np.float64) - want[key]).max())
        assert gap <= GRAD_REL * scale, f"{key}: max gap {gap:.3g} > {GRAD_REL} x {scale:.3g}"


def test_full_config_and_smoke():
    want = dataclasses.asdict(jax_mace_config._cfg(jax_base.GNN_SHAPES["molecule"]))
    got = dataclasses.asdict(mace_config.FULL)
    assert {k: v for k, v in got.items() if k != "dtype"} == {k: v for k, v in want.items() if k != "dtype"}
    metrics = mace_config.smoke(device="cpu")
    assert set(metrics) == set(jax_mace_config.smoke()) and all(np.isfinite(v) for v in metrics.values())


def test_trainer_follows_jax_trainer_at_launcher_config():
    """The JAX launcher's MACE task (``repro.launch.train.train_gnn``,
    lines 64-78) against the port's, 10 steps from the JAX weights."""
    mol = jax_datasets.load("molecules", scale=0.1)
    jcfg = jax_mace.MaceConfig(d_hidden=32, n_layers=2)
    jparams = jax_mace.init(jcfg, jax.random.PRNGKey(0))
    n_mols = int(mol.node_attrs["mol_id"].max()) + 1
    args = (jnp.asarray(mol.node_attrs["species"]), jnp.asarray(mol.node_attrs["pos"]), jnp.asarray(mol.senders),
            jnp.asarray(mol.receivers), jnp.asarray(mol.node_attrs["mol_id"]), n_mols)
    target = jnp.asarray(np.random.default_rng(0).normal(size=n_mols).astype(np.float32))

    def jloss(p, _):
        e, _feats = jax_mace.forward(jcfg, p, *args)
        return jnp.mean((e - target) ** 2)

    cfg, _, batch = launch_train.gnn_task("mace", device="cpu")
    assert cfg == mace.MaceConfig(d_hidden=32, n_layers=2)
    for key, want in (("species", args[0]), ("pos", args[1]), ("senders", args[2]), ("receivers", args[3]),
                      ("mol_id", args[4]), ("target", target)):
        assert np.array_equal(batch[key].numpy(), np.asarray(want)), key
    params = convert.mace_params_from_arrays(_np(jparams), 2, device="cpu")
    opt = dict(lr=5e-3, warmup_steps=5, total_steps=10, weight_decay=0.0)
    jtr = JaxTrainer(jloss, jparams, JaxAdamWConfig(**opt), JaxTrainerConfig(total_steps=10, log_every=1))
    jtr.fit(iter(lambda: {"_": jnp.zeros(())}, None))
    tr = Trainer(lambda p, b: launch_train.gnn_loss(cfg, p, b), params, adamw.AdamWConfig(**opt),
                 TrainerConfig(total_steps=10, log_every=1))
    tr.fit(iter(lambda: batch, None))
    assert tr.step == jtr.step == 10
    for key in ("loss", "grad_norm", "lr"):
        got, want = [m[key] for m in tr.metrics_log], [m[key] for m in jtr.metrics_log]
        np.testing.assert_allclose(got[:EXACT_STEPS], want[:EXACT_STEPS], rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(got, want, rtol=DRIFT_RTOL, err_msg=key)
