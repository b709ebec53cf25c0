"""Mesh shapes for the launchers.

Port of `repro/launch/mesh.py::make_mesh_for`. The port's mesh is a
plain `{axis: size}` dict (every rank a row of a stacked tensor on one
device), so building one touches no device state.
"""
from __future__ import annotations


def make_mesh_for(devices: int, tp: int = None) -> dict:
    """The (pod, data, model) = (1, devices / tp, tp) mesh; tp defaults to
    2 for an even device count, else 1."""
    tp = tp or (2 if devices % 2 == 0 else 1)
    if devices % tp:
        raise ValueError(f"{devices} devices do not split into tp={tp}")
    return {"pod": 1, "data": devices // tp, "model": tp}
