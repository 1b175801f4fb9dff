"""The paper's own experiment configuration (datasets × partitioners × k).

Twin of ``repro.configs.paper_didic``: not a model, the reproduction
config that ``python -m repro_torch.partition_and_serve`` and
``chip_smoke.py`` read.
"""

import dataclasses
from typing import Tuple

from repro_torch.core.didic import DidicConfig


@dataclasses.dataclass(frozen=True)
class PaperExperimentConfig:
    datasets: Tuple[str, ...] = ("filesystem", "gis", "twitter")
    scale: float = 0.01            # fraction of the paper's dataset sizes
    partition_counts: Tuple[int, ...] = (2, 4)
    n_ops: int = 2_000             # evaluation-log length (paper: 10 000)
    n_ops_gis: int = 300           # the GIS replay is host-paced
    didic_iterations: int = 100    # paper: 100 initial
    dynamism_levels: Tuple[float, ...] = (0.01, 0.02, 0.05, 0.10, 0.25)
    seed: int = 0

    def didic(self, dataset: str, k: int) -> DidicConfig:
        # Trees need the widest assignment smoothing.
        cap = 256 if dataset == "filesystem" else 64
        return DidicConfig(k=k, iterations=self.didic_iterations, smooth_cap=cap)


DEFAULT = PaperExperimentConfig()
