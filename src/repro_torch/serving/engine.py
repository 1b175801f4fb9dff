"""Fixed-slot continuous batching for the LM (twin of ``repro.serving.engine``).

Slots hold decoding requests over one shared KV cache; a FIFO queue
back-fills a slot as soon as it frees, and each :meth:`ServingEngine.step`
decodes one token for every active slot through
:func:`~repro_torch.models.transformer.serve_step`. The JAX package's
prefill is one jitted ``lax.scan`` of ``serve_step`` over the prompt; here
it is the same loop on the host, one ``serve_step`` per prompt token.

Two behaviours of the JAX engine are kept as they are, so that both give
the same tokens:

1. prefill broadcasts each prompt token to *every* slot at position t, so
   admitting a request overwrites the other slots' cache entries at the
   prompt's positions;
2. a decode step runs every slot at one shared clock,
   ``max(positions of the active slots)``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new_tokens: int = 16
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: tf.TransformerConfig, params: Any, batch_slots: int, max_len: int,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.slots = batch_slots
        self.max_len = max_len
        self.cache = tf.init_kv_cache(cfg, batch_slots, max_len, device=self.device)
        self.positions = np.zeros(batch_slots, dtype=np.int64)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.queue: Deque[Request] = deque()

    def _prefill(self, prompt: np.ndarray) -> None:
        for t, tok in enumerate(np.asarray(prompt, dtype=np.int32)):
            token = torch.full((self.slots,), int(tok), dtype=torch.int32, device=self.device)
            _, self.cache = tf.serve_step(self.cfg, self.params, token, self.cache, t)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                req = self.queue.popleft()
                self.active[i] = req
                if len(req.prompt):
                    self._prefill(req.prompt)
                self.positions[i] = len(req.prompt)

    @torch.no_grad()
    def step(self) -> int:
        """One decode step over all active slots; returns the number active."""
        self._admit()
        active_idx = [i for i, r in enumerate(self.active) if r is not None]
        if not active_idx:
            return 0
        last_tokens = np.zeros(self.slots, dtype=np.int32)
        for i in active_idx:
            r = self.active[i]
            last_tokens[i] = r.generated[-1] if r.generated else r.prompt[-1]
        pos = int(self.positions[active_idx].max())  # the shared clock
        logits, self.cache = tf.serve_step(
            self.cfg, self.params, torch.as_tensor(last_tokens, device=self.device), self.cache, pos)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in active_idx:
            r = self.active[i]
            r.generated.append(int(nxt[i]))
            self.positions[i] += 1
            if len(r.generated) >= r.max_new_tokens or self.positions[i] >= self.max_len - 1:
                r.done = True
                self.active[i] = None  # continuous batching: free the slot
        return len(active_idx)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                return
