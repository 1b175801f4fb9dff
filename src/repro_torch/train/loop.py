"""Training loop: pure steps, checkpoint and restart, fault tolerance (twin
of ``repro.train.loop``).

The step is a pure function ``(train_state, batch) → (train_state,
metrics)``: it takes the gradients with ``torch.autograd.grad`` on detached
copies of the parameters that require grad (views, no data copied), and
hands them to the pure :func:`repro_torch.optim.adamw.update`. So the
straggler mitigator can re-dispatch a step and get the same state. The
price is memory: at the update the old and the new parameters and moments
are alive together. The loop owns the impure parts: the data cursor, the
checkpoint cadence, recovery from a :class:`SimulatedFault` (restore the
latest checkpoint and go on; the data iterator is not rewound; counted in
``Trainer.recoveries``, which the JAX trainer lacks) and the metrics log.

``grad_accum > 1`` takes a batch whose leaves have a leading microbatch
axis and sums the microbatches' float32 gradients in a Python loop (the
JAX package scans it). ``bf16_grads`` rounds every gradient through
bfloat16 before the update. On the card a step ends in a device
synchronize, so ``step_time_s`` and the straggler deadline see the
device's time, not the enqueue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.distributed.sharding import batch_axes
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import FaultInjector, SimulatedFault, StragglerMitigator

Tree = Dict[str, Any]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_async: bool = False
    log_every: int = 10
    grad_accum: int = 1
    bf16_grads: bool = False      # gradient compression before reduction


def value_and_grad(loss_f: Callable[[Tree], torch.Tensor], params: Tree, mesh=None):
    """``loss_f(params)`` and its gradient tree, as ``jax.value_and_grad``
    gives them: a leaf the loss does not reach gets a zero gradient (and
    AdamW still decays it). With a mesh (the loss then the global one, as
    ``transformer.loss_fn(..., mesh=)`` gives it) each leaf's gradient is
    summed over the batch axes; a leaf split over the model axis keeps this
    rank's part."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_f(live)
        grads = list(torch.autograd.grad(loss, list(adamw.leaves(live)), allow_unused=True,
                                         materialize_grads=True))
    if mesh is not None:
        axes = batch_axes(mesh)
        for i, g in enumerate(grads):
            grads[i] = mesh.all_reduce(g, axis=axes)
    return loss.detach(), adamw.tree_unflatten(live, grads)


class Trainer:
    def __init__(
        self,
        loss_fn: Callable[[Tree, Dict[str, torch.Tensor]], torch.Tensor],
        params: Tree,
        opt_cfg: adamw.AdamWConfig,
        cfg: TrainerConfig,
        fault_injector: Optional[FaultInjector] = None,
    ):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.loss_fn = loss_fn
        self.state = {"params": params, "opt": adamw.init(params)}
        self.step = 0
        self.recoveries = 0
        self.fault = fault_injector or FaultInjector()
        self.straggler = StragglerMitigator()
        self.metrics_log: list = []
        self._maybe_restore()

    # ------------------------------------------------------------------
    def _one_grad(self, params: Tree, batch: Dict[str, torch.Tensor]):
        """The loss and the gradients of every parameter, in its dtype
        (float32 with ``bf16_grads``)."""
        loss, grads = value_and_grad(lambda p: self.loss_fn(p, batch), params)
        if self.cfg.bf16_grads:
            # gradient compression: bf16 for the cross-replica reduction,
            # float32 again before the update.
            grads = tree_map(lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
        return loss, grads

    def _train_step(self, state: Tree, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if self.cfg.grad_accum > 1:
            loss = torch.zeros((), dtype=torch.float32, device=state["opt"]["step"].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(self.cfg.grad_accum):
                mb_loss, g = self._one_grad(params, {k: v[i] for k, v in batch.items()})
                loss = loss + mb_loss
                grads = tree_map(torch.add, grads, g)
            loss = loss / self.cfg.grad_accum
            grads = tree_map(lambda g: g / self.cfg.grad_accum, grads)
        else:
            loss, grads = self._one_grad(params, batch)
        params, opt, om = adamw.update(params, grads, state["opt"], self.opt_cfg)
        if loss.device.type == "cuda":
            torch.cuda.synchronize(loss.device)
        return {"params": params, "opt": opt}, {"loss": loss, **om}

    # ------------------------------------------------------------------
    def _maybe_restore(self) -> None:
        if not self.cfg.ckpt_dir:
            return
        restored = ckpt.restore_latest(self.cfg.ckpt_dir, self.state)
        if restored is not None:
            self.step, self.state, extra = restored
            print(f"[trainer] restored checkpoint @ step {self.step}")

    def _save(self) -> None:
        if not self.cfg.ckpt_dir:
            return
        if self.cfg.ckpt_async:
            ckpt.save_async(self.cfg.ckpt_dir, self.step, self.state)
        else:
            ckpt.save(self.cfg.ckpt_dir, self.step, self.state)

    # ------------------------------------------------------------------
    def fit(self, data: Iterator[Dict[str, torch.Tensor]]) -> Dict[str, float]:
        """Run to total_steps with fault recovery; returns final metrics."""
        last = {}
        while self.step < self.cfg.total_steps:
            batch = next(data)
            try:
                self.fault.check(self.step)
                t0 = time.perf_counter()
                self.state, m = self.straggler.run_with_mitigation(
                    self._train_step, self.state, batch
                )
                dt = time.perf_counter() - t0
            except SimulatedFault as e:
                print(f"[trainer] {e} — recovering from checkpoint")
                self.recoveries += 1
                self._maybe_restore()
                continue
            self.step += 1
            if self.step % self.cfg.log_every == 0 or self.step == self.cfg.total_steps:
                last = {k: float(v) for k, v in m.items()}
                last["step_time_s"] = dt
                self.metrics_log.append({"step": self.step, **last})
            if self.step % self.cfg.ckpt_every == 0:
                self._save()
        self._save()
        return last

