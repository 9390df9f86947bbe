"""Rotations and parallel transport on the sphere, on torch tensors.

Port of calclens_tpu/rays/paratrans.py (the reference's rot_paratrans.c):
axis-angle rotations and the psi-angle parallel transport of tangent
vectors and tensors along great circles (rot_paratrans.c:101-273), on
[..., 3] vectors and [..., 2, 2] tensors broadcast over leading batch
dimensions, branch-free.  The galaxy image search calls these; the ray step
keeps its own componentwise helpers (rays/soa.py).
"""

from __future__ import annotations

import torch


def _dot(a, b):
    return (a * b).sum(dim=-1)


def rotate_axis_angle(vec, axis, cosangle, sinangle):
    """Rodrigues rotation of `vec` about unit `axis` (counter-clockwise),
    rot_vec_axis_trigangle_countercw (rot_paratrans.c:78-92).  cosangle and
    sinangle have shape vec.shape[:-1]."""
    axisdotvec = _dot(axis, vec)[..., None]
    axiscrossvec = torch.linalg.cross(axis, vec, dim=-1)
    c = cosangle[..., None]
    s = sinangle[..., None]
    return vec * c + axis * axisdotvec * (1.0 - c) + axiscrossvec * s


def _transport_psi(vec, rvec):
    """cos(psi), sin(psi) of the basis rotation induced by parallel
    transport from unit vector `vec` to unit vector `rvec` along the great
    circle: R(e_theta) = cos(psi) e_theta' - sin(psi) e_phi',
    R(e_phi) = sin(psi) e_theta' + cos(psi) e_phi' (rot_paratrans.c:158-166).
    """
    vec, rvec = torch.broadcast_tensors(vec, rvec)
    axis = torch.linalg.cross(vec, rvec, dim=-1)
    cosangle = _dot(vec, rvec)
    sinangle = torch.linalg.vector_norm(axis, dim=-1)
    safe = sinangle > 0.0
    x_axis = torch.zeros_like(axis)
    x_axis[..., 0] = 1.0
    axis = torch.where(
        safe[..., None],
        axis / torch.where(safe, sinangle, 1.0)[..., None], x_axis)

    # rotate e_phi(vec) into rvec's tangent plane
    zeros = torch.zeros_like(vec[..., 0])
    p = torch.stack([-vec[..., 1], vec[..., 0], zeros], dim=-1)
    rephi = rotate_axis_angle(p, axis, cosangle, sinangle)

    ephi_r = torch.stack([-rvec[..., 1], rvec[..., 0], zeros], dim=-1)
    etheta_r = torch.stack([
        rvec[..., 2] * rvec[..., 0],
        rvec[..., 2] * rvec[..., 1],
        -(rvec[..., 0] ** 2 + rvec[..., 1] ** 2)], dim=-1)

    norm = torch.sqrt((1.0 - rvec[..., 2]) * (1.0 + rvec[..., 2])
                      * (1.0 - vec[..., 2]) * (1.0 + vec[..., 2]))
    inv = 1.0 / torch.where(norm > 0.0, norm, 1.0)
    sinpsi = _dot(rephi, etheta_r) * inv
    cospsi = _dot(rephi, ephi_r) * inv
    # transport to the same point: identity
    same = sinangle == 0.0
    return torch.where(same, 1.0, cospsi), torch.where(same, 0.0, sinpsi)


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def paratrans_tangvec(tvec, vec, rvec):
    """Transport tangent vector tvec = (t_theta, t_phi) from vec to rvec."""
    cospsi, sinpsi = _transport_psi(_unit(vec), _unit(rvec))
    t0 = tvec[..., 0] * cospsi + tvec[..., 1] * sinpsi
    t1 = -tvec[..., 0] * sinpsi + tvec[..., 1] * cospsi
    return torch.stack([t0, t1], dim=-1)


def paratrans_tangtensor(T, vec, rvec):
    """Transport 2x2 tangent tensor T (theta-phi basis) from vec to rvec:
    T' = R^T T R with R = [[c, -s], [s, c]] (rot_paratrans.c:236-270),
    the 2x2 products written out."""
    c, s = _transport_psi(_unit(vec), _unit(rvec))
    t00, t01, t10, t11 = T[..., 0, 0], T[..., 0, 1], T[..., 1, 0], T[..., 1, 1]
    # M = T R
    m00 = t00 * c + t01 * s
    m01 = -t00 * s + t01 * c
    m10 = t10 * c + t11 * s
    m11 = -t10 * s + t11 * c
    # R^T M
    return torch.stack([
        torch.stack([c * m00 + s * m10, c * m01 + s * m11], dim=-1),
        torch.stack([-s * m00 + c * m10, -s * m01 + c * m11], dim=-1),
    ], dim=-2)
