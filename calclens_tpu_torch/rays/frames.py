"""Ray frame conversions for I/O (reference rot_paratrans.c:274-411).

Port of calclens_tpu/rays/frames.py.  Before writing, rays are expressed in
the OBSERVER frame: A and Aprev parallel-transported from the ray's current
position back to its initial pixel center, then rotated from the (theta,
phi) basis to the (ra, dec) basis (rayio.c:299-347).  Both operations have
exact inverses, used when resuming.  Works on a Rays view of torch tensors
(rays/propagate.py); the packed writer's device form is
rays/soa.output_rows_obs_radec.
"""

from __future__ import annotations

import torch

from .paratrans import paratrans_tangtensor


def paratrans_rays_curr2obs(rays, obs_vec):
    """Transport A and Aprev from the current position n to the observer
    (initial pixel-center) direction obs_vec [N, 3]."""
    return rays._replace(
        A=paratrans_tangtensor(rays.A, rays.n, obs_vec),
        Aprev=paratrans_tangtensor(rays.Aprev, rays.n, obs_vec),
    )


def paratrans_rays_obs2curr(rays, obs_vec):
    """Inverse of paratrans_rays_curr2obs."""
    return rays._replace(
        A=paratrans_tangtensor(rays.A, obs_vec, rays.n),
        Aprev=paratrans_tangtensor(rays.Aprev, obs_vec, rays.n),
    )


def _basis_swap(M):
    """theta-phi <-> ra-dec 2x2 tensor basis change (self-inverse):
    M'[0,0]=M[1,1], M'[1,0]=-M[0,1], M'[0,1]=-M[1,0], M'[1,1]=M[0,0]."""
    return torch.stack([
        torch.stack([M[..., 1, 1], -M[..., 1, 0]], dim=-1),
        torch.stack([-M[..., 0, 1], M[..., 0, 0]], dim=-1),
    ], dim=-2)


def rot_rays_ang2radec(rays):
    """(theta, phi) basis -> (ra, dec) basis: alpha (a0, a1) -> (a1, -a0),
    A, Aprev and U by _basis_swap (rot_ray_ang2radec)."""
    alpha = torch.stack([rays.alpha[..., 1], -rays.alpha[..., 0]], dim=-1)
    return rays._replace(alpha=alpha, A=_basis_swap(rays.A),
                         Aprev=_basis_swap(rays.Aprev), U=_basis_swap(rays.U))


def rot_rays_radec2ang(rays):
    """Inverse: alpha (a0, a1) -> (-a1, a0), tensors by the same swap."""
    alpha = torch.stack([-rays.alpha[..., 1], rays.alpha[..., 0]], dim=-1)
    return rays._replace(alpha=alpha, A=_basis_swap(rays.A),
                         Aprev=_basis_swap(rays.Aprev), U=_basis_swap(rays.U))
