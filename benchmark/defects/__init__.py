"""Kinds of surface defect, one module each, found by the ``kind`` of an
entry of a mirror's ``defects`` list. A module holds, for its kind:

* ``port(spec, support)``: the port's defect object (``support`` the port's);
* ``reference(spec, support)``: the reference's
  :class:`benchmark.reference.optics.Defect` (``support`` the reference's tuple);
* ``height(defect, x, y)``: the height error [mm] at points of the mirror's
  vertex frame (the program traces with ``ignore_defects`` True: the hit
  moves along the ray by the height, the normal stays the bare surface's);
* ``ops(defect)``: the work model's operations per ray it adds to a step,
  and ``dual_ops(defect, n_tangents)``: those it adds to a gradient step."""

from .. import route


def kind(name: str):
    return route.module("defects", name)


def specs(optic_spec: dict) -> list:
    """A mirror's defect entries: its ``defects`` list, and a ``zernike``
    list of ``[n, m, coefficient mm]`` rows as one Zernike entry."""
    out = list(optic_spec.get("defects", []))
    if optic_spec.get("zernike"):
        out.append({"kind": "zernike", "terms": optic_spec["zernike"]})
    return out
