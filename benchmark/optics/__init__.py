"""Kinds of optic, one module each, found by the configuration's ``kind``.
A module holds, for its kind:

* ``port(spec, support)``: the port's optic object (``support`` the port's);
* ``reference(spec, support)``: the reference's
  :class:`benchmark.reference.optics.Optic` (``support`` the reference's tuple);
* ``hit(optic, q, u)``: ``(t, valid, point, normal)`` of rays ``q + t u`` on
  the bare surface in its vertex frame, in the dtype it is given; ``normal``
  None for an optic the rays pass through (a mask);
* ``normal(optic, point)``: the bare surface's unit normal at ``point``
  (where a defect moves the hit), for a mirror;
* ``step_ops(optic)``: the work model's float32 operations of one ray
  through it, and optionally ``folded_ops(optic)``: those of a ray through
  it where the forward kernels fold it into the next step as a test."""

from .. import route


def kind(name: str):
    return route.module("optics", name)
