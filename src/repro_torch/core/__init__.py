"""Core of the port: partitioners, DiDiC, traffic replay, metrics, service.

Submodules are imported by name (``from repro_torch.core import traffic``);
importing this package loads none of them.
"""
