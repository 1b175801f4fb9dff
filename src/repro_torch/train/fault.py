"""Fault injection and straggler mitigation for the training loop (twin of
``repro.train.fault``).

The implementation lives in :mod:`repro_torch.core.fault`, where the same
primitives serve the partitioned service. This module re-exports the
training loop's names:

* :class:`FaultInjector` raises :class:`SimulatedFault` on configured
  steps; the trainer recovers by restoring the latest checkpoint.
* :class:`StragglerMitigator` re-dispatches a step that exceeds
  ``deadline_factor × ewma`` of the step durations, which is safe because a
  step is a pure function of (state, batch).
"""

from __future__ import annotations

from repro_torch.core.fault import FaultInjector, SimulatedFault, StragglerMitigator

__all__ = ["FaultInjector", "SimulatedFault", "StragglerMitigator"]
