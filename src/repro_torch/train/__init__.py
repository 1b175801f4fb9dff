"""The training loop of the port (twin of ``repro.train``): AdamW steps,
checkpoint and restart, fault recovery and straggler mitigation."""

from repro_torch.train import checkpoint, fault, loop
from repro_torch.train.loop import Trainer, TrainerConfig

__all__ = ["checkpoint", "fault", "loop", "Trainer", "TrainerConfig"]
