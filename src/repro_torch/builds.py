"""Build events: where the port builds a device program or its buffers.

Torch eager compiles nothing, so the port's analogue of a JAX retrace is an
object that holds a device program or its capacity buffers being built
again. The few sites that build one call :func:`note_build`: the
construction of a batched traffic engine, a sharded replayer and a capacity
mesh program, and the loading of a CUDA kernel's library. The sites that
rewrite a growth lineage's tables for its grown extents, which the JAX
package also does without a retrace (the DiDiC overlay tables, the mesh
program's halo tables), call :func:`note_refresh`.

Both do nothing while no listener is set; a listener (the growth sentinel
of :mod:`repro_torch.analysis.recompile`) is called with ``(kind, name,
geometry)``, ``kind`` being ``"build"`` or ``"refresh"``.
"""

from __future__ import annotations

from typing import Callable, List

__all__ = ["add_listener", "remove_listener", "note_build", "note_refresh", "geometry"]

Listener = Callable[[str, str, tuple], None]

_LISTENERS: List[Listener] = []


def add_listener(fn: Listener) -> None:
    _LISTENERS.append(fn)


def remove_listener(fn: Listener) -> None:
    _LISTENERS.remove(fn)


def geometry(graph) -> tuple:
    """What a graph's device buffers are sized to: its store's ``(n_cap,
    e_cap)``, else its own ``(n_nodes, n_edges)``."""
    store = graph.store
    if store is not None:
        return (store.n_cap, store.e_cap)
    return (graph.n_nodes, graph.n_edges)


def note_build(name: str, geometry: tuple) -> None:
    """An object holding a device program or its buffers was built."""
    for fn in _LISTENERS:
        fn("build", name, geometry)


def note_refresh(name: str, geometry: tuple) -> None:
    """A lineage's tables were rewritten for its grown extents."""
    for fn in _LISTENERS:
        fn("refresh", name, geometry)
