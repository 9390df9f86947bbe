"""Flat LambdaCDM comoving-distance tables (reference cosmocalc.c).

The reference integrates 1/sqrt(Om*a + (1-Om)*a^4) over a with GSL QAG on a
20,000-point table (cosmocalc.c:25-55) with the Hubble distance hard-coded to
2997.92458 Mpc/h (h = 1 units).  Here the same integral is evaluated once on
the host with adaptive Gauss-Kronrod (scipy) on the same a-grid, and lookups
are monotone interpolations on numpy arrays.

The port's own copy of calclens_tpu/cosmology.py (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds the two alike.
"""

from __future__ import annotations

import numpy as np
from scipy import integrate

RHO_CRIT = 2.77519737e11  # h^2 Msun/Mpc^3 (reference raytrace.h:108)
CSOL = 299792.458  # km/s (reference raytrace.h:109)
DH = 2997.92458  # Hubble distance c/H0 in Mpc/h (reference cosmocalc.c:44)

_TABLE_LENGTH = 20000
_AEXPN_MIN = 0.01
_AEXPN_MAX = 1.0


class Cosmology:
    """Distance calculator for flat LCDM, h = 1 units (Mpc/h)."""

    def __init__(self, omega_m: float, table_length: int = _TABLE_LENGTH):
        self.omega_m = float(omega_m)
        a = np.linspace(_AEXPN_MIN, _AEXPN_MAX, table_length)

        def integrand(x):
            return 1.0 / np.sqrt(self.omega_m * x + (1.0 - self.omega_m) * x**4)

        # cumulative integral from each a to 1 (a=1 -> chi=0), evaluated on a
        # refined grid so the composite rule matches the reference's adaptive
        # integration to ~1e-10 relative
        refine = 8
        af = np.linspace(_AEXPN_MIN, _AEXPN_MAX, (table_length - 1) * refine + 1)
        cum = integrate.cumulative_simpson(integrand(af), x=af, initial=0.0)
        chi = (cum[-1] - cum[::refine]) * DH
        self.a_table = a
        self.chi_table = chi  # decreasing in a

    def comvdist(self, a):
        """Comoving distance chi(a) in Mpc/h."""
        a = np.asarray(a, dtype=np.float64)
        return np.interp(a, self.a_table, self.chi_table)

    def acomvdist(self, chi):
        """Scale factor a(chi): inverse of comvdist."""
        chi = np.asarray(chi, dtype=np.float64)
        # chi_table decreases with a; flip for np.interp
        return np.interp(chi, self.chi_table[::-1], self.a_table[::-1])

    def comvdist_z(self, z):
        return self.comvdist(1.0 / (1.0 + np.asarray(z, dtype=np.float64)))

    def angdist(self, a):
        """Angular diameter distance to scale factor a (Mpc/h, physical)."""
        return np.asarray(a) * self.comvdist(a)

    def angdistdiff(self, amin, amax):
        """Angular diameter distance between two epochs (flat universe):
        amin is the more distant epoch (reference cosmocalc.c angdistdiff)."""
        return np.asarray(amin) * (self.comvdist(amin) - self.comvdist(amax))
