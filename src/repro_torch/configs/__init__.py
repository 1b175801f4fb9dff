"""Model configurations of the port and their registry (twin of ``repro.configs``).

Each architecture module holds its full published config (``FULL``) and
registers an :class:`~repro_torch.configs.base.ArchConfig` with
:mod:`.base`: its shapes, skipped cells, dry-run cell builders and smoke
run. ``python -m repro_torch.launch.dryrun`` runs the cells on the
``meta`` device."""

from repro_torch.configs import base
from repro_torch.configs.base import all_archs, all_cells, get, skipped_cells

__all__ = ["base", "all_archs", "all_cells", "get", "skipped_cells"]
