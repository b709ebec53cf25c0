"""Mesh shapes for the launchers and the dry run.

Port of `repro/launch/mesh.py`. The port's mesh is a plain `{axis:
size}` dict (every rank a row of a stacked tensor on one device), so
building one touches no device state.
"""
from __future__ import annotations

from repro_torch.core.topology import make_mesh

POD_CHIPS = 256


def make_production_mesh(*, multi_pod: bool = False, tp: int = 16) -> dict:
    """16x16 chips per pod; the multi-pod mesh adds a 2-pod DCN axis.

    `tp` retiles the same 256 chips per pod between the data and model
    axes: (256 / tp, tp) as ("data", "model"), or (2, 256 / tp, tp) as
    ("pod", "data", "model")."""
    if POD_CHIPS % tp:
        raise ValueError(f"tp={tp} does not divide {POD_CHIPS} chips")
    if multi_pod:
        return make_mesh((2, POD_CHIPS // tp, tp), ("pod", "data", "model"))
    return make_mesh((POD_CHIPS // tp, tp), ("data", "model"))


def make_mesh_for(devices: int, tp: int = None) -> dict:
    """The (pod, data, model) = (1, devices / tp, tp) mesh; tp defaults to
    2 for an even device count, else 1."""
    tp = tp or (2 if devices % 2 == 0 else 1)
    if devices % tp:
        raise ValueError(f"{devices} devices do not split into tp={tp}")
    return make_mesh((1, devices // tp, tp), ("pod", "data", "model"))
