"""Ray state view (port of calclens_tpu/rays/propagate.py::Rays).

The port keeps rays packed as one [21, N] buffer (rays/soa.py), which also
carries the propagation; Rays is the array-of-struct view of that buffer
(the layout of the reference's HEALPixRay, raytrace.h:284-293), used for
host views and the npz restart.
"""

from __future__ import annotations

from typing import Any, NamedTuple


class Rays(NamedTuple):
    """Array-of-struct ray view (numpy arrays or torch tensors)."""

    n: Any      # [N, 3] position, |n| = current plane radius
    beta: Any   # [N, 3] direction
    A: Any      # [N, 2, 2] inverse magnification matrix
    Aprev: Any  # [N, 2, 2] A at the previous plane
    alpha: Any  # [N, 2] per-plane deflection (theta, phi components)
    U: Any      # [N, 2, 2] per-plane shear tensor
    phi: Any    # [N] lensing potential at the ray
