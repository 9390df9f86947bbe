"""Galaxy image grid search (reference gridsearch.c) on torch tensors.

Port of the single-device part of calclens_tpu/gals/gridsearch.py.  A
source galaxy at comoving position g whose radius falls in the current
plane's radial bin is imaged wherever the deformed ray grid (the rays
propagated, deflection-free, to the galaxy's radius) has a triangle that
contains g:

  1. candidate ray pixels: a ring/phi window of RING pixels around the
     galaxy (torchhp.ring_window), cut to the topk pixel centres nearest it;
     the host path takes the children of the galaxy's coarse cell and its 8
     neighbours instead,
  2. their triangles (torchhp.triangles_ring, the reference's
     ring2triangle; the host table healpix.core.build_triangles),
  3. per vertex: the geodesic chord to the galaxy's radius
     (rayprop_gridsearch, gridsearch.c:1120-1200),
  4. gnomonic projection into the galaxy's tangent plane and the
     barycentric test (tritest_getbarycoords, gridsearch.c:1201-1230),
  5. the image position from the barycentric-weighted ray STARTING
     positions, near-duplicate hits on shared edges removed,
  6. A at the image: 4-pixel bilinear interpolation with double parallel
     transport (interp_invmagmat_to_point, gridsearch.c:209-298), in the
     ra-dec basis.

The device search (find_images_device_async) queues every step for every
chunk on the ray buffer's device without a host sync; only its collect()
reads the hit counts.  A chunk whose hits overflow the fixed hit buffer
is searched again by the host-prep find_images on the same buffer.  The
mesh-sharded search of the JAX package is not ported here (ROADMAP Queue 1,
slice 14).  Eager torch computes each value once, so the floor() knife
edges that the JAX package pins with optimization barriers are decided
once; the search is not compiled, which would bring that hazard back.
The device search takes an image's theta as atan2(rho, z), not JAX's
arccos(z / r): in float32 that keeps its polar images as close to a
float64 search as JAX's or closer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..healpix import core as hp
from ..healpix import torchhp
from ..rays.paratrans import paratrans_tangtensor

# barycentric slack: in float32 a source on a shared edge can round
# outside both triangles and lose its image; the edge double hits are
# removed by the position dedup
BARY_EPS = 1e-5


class ImageGals(NamedTuple):
    """Found images (host arrays)."""

    index: np.ndarray  # source catalog index
    ra: np.ndarray
    dec: np.ndarray
    A: np.ndarray      # [N, 2, 2] in the ra-dec basis


def _no_images():
    return ImageGals(np.zeros(0, np.int64), np.zeros(0), np.zeros(0),
                     np.zeros((0, 2, 2)))


def _concat(parts):
    if not parts:
        return _no_images()
    return ImageGals(*(np.concatenate(f) for f in zip(*parts)))


class GridSearchTables:
    """Per-rayOrder host tables reused across planes."""

    def __init__(self, ray_order: int, expand: int = 2):
        self.ray_order = ray_order
        self.expand = min(expand, ray_order)
        self.coarse_order = ray_order - self.expand
        tri_ring = hp.build_triangles(ray_order)          # [npix, 4, 3] ring
        npix = int(hp.order2npix(ray_order))
        ring_of = np.arange(npix, dtype=np.int64)
        self.nest_of_ring = hp.ring2nest(ring_of, ray_order)
        mask = tri_ring >= 0
        tri_nest = np.where(mask, self.nest_of_ring[np.clip(tri_ring, 0, npix - 1)], -1)
        self.tri_nest = tri_nest                          # [npix(ring), 4, 3]
        self.ring_of_nest = hp.nest2ring(ring_of, ray_order)


def _gal_candidates(tables: GridSearchTables, gvec):
    """Host: candidate base pixels (RING indices) per galaxy [G, C]."""
    oc = tables.coarse_order
    k = tables.expand
    theta, phi = hp.vec2ang(gvec)
    cnest = hp.ang2pix_nest(theta, phi, oc)
    nb = hp.neighbors_nest(cnest, oc)                      # [G, 8]
    cells = np.concatenate([cnest[:, None], nb], axis=1)   # [G, 9]
    cells = np.where(cells < 0, cnest[:, None], cells)     # pad missing with self
    children = (cells[:, :, None] << (2 * k)) + np.arange(4 ** k, dtype=np.int64)
    nest = children.reshape(len(gvec), -1)                 # [G, 9*4^k]
    return tables.ring_of_nest[nest]                       # ring indices


def _np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _upload(x, np_dtype, device):
    """Host array -> tensor on device, cast on the host first.  On a GPU
    through pinned memory with non_blocking, so the copy never waits for
    the kernels already queued."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np_dtype))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _scalar(x, like):
    """0-d tensor of x in like's dtype on like's device (a fill: no copy)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _chord(n, beta, wp, wpm1):
    """Ray positions n + lambda beta at radius wp: the smaller-|lambda|
    root of the chord equation (rayprop_gridsearch)."""
    qb = 2.0 * (n * beta).sum(dim=-1)
    qc = wpm1 * wpm1 - wp * wp
    disc = torch.sqrt(torch.clamp(qb * qb - 4.0 * qc, min=0.0))
    q = -0.5 * (qb + torch.sign(qb) * disc)
    lam1 = qc / torch.where(q != 0.0, q, 1.0)
    lam = torch.where(lam1.abs() > q.abs(), q, lam1)
    return n + beta * lam[..., None]


def _rayprop_gs(n, beta, A, Aprev, wp, wpm1, wpm2):
    """Vectorized rayprop_gridsearch: 2-term A shift, the chord, parallel
    transport of A to the new position.  wp broadcasts."""
    f = wpm1 * (wp - wpm2) / (wp * (wpm1 - wpm2))
    Ap = (1.0 - f)[..., None, None] * Aprev + f[..., None, None] * A
    np_ = _chord(n, beta, wp, wpm1)
    return np_, paratrans_tangtensor(Ap, n, np_)


def _gather_vec(packed, r0, idx):
    """packed [21, N] rows r0..r0+2 at ray indices idx [...] -> [..., 3]."""
    return torch.stack([packed[r0 + k][idx] for k in range(3)], dim=-1)


def _gather_mat(packed, r0, idx):
    """packed rows r0..r0+3 -> [..., 2, 2] (A row layout, rays/soa.py)."""
    a = [packed[r0 + k][idx] for k in range(4)]
    return torch.stack([torch.stack([a[0], a[1]], -1),
                        torch.stack([a[2], a[3]], -1)], -2)


def _barycentric(npos, wp, gvec, tvec, pvec, vmask, vert_cvec):
    """Barycentric hit test of the galaxies (origin of their tangent
    planes) in the triangles of the propagated vertices npos [G, T, 3, 3]:
    returns hit [G, T] and the image's tangent coordinates (ix, iy) from
    the vertices' starting pixel centres vert_cvec."""
    def on(v):
        return v[:, None, None, :]

    cosang = (npos * on(gvec)).sum(dim=-1) / wp            # [G, T, 3]
    x = (npos * on(tvec)).sum(dim=-1) / wp / cosang
    y = (npos * on(pvec)).sum(dim=-1) / wp / cosang

    ax, ay = x[..., 0] - x[..., 2], y[..., 0] - y[..., 2]
    bx, by = x[..., 1] - x[..., 2], y[..., 1] - y[..., 2]
    qx, qy = -x[..., 2], -y[..., 2]
    den = ax * by - bx * ay
    safe = torch.where(den.abs() > 0, den, 1.0)
    b0 = (qx * by - bx * qy) / safe
    b1 = (ax * qy - qx * ay) / safe
    b2 = 1.0 - b0 - b1
    bcs = torch.stack([b0, b1, b2], dim=-1)
    hit = ((den.abs() > 0) & (bcs >= -BARY_EPS).all(dim=-1)
           & (bcs <= 1.0 + BARY_EPS).all(dim=-1) & vmask)

    # image position: barycentric-weighted STARTING positions (gnomonic
    # weights bcs * cosang, gridsearch.c:753-770)
    w = bcs * cosang
    sx = (vert_cvec * on(tvec)).sum(dim=-1)
    sy = (vert_cvec * on(pvec)).sum(dim=-1)
    return hit, (sx * w).sum(dim=-1), (sy * w).sum(dim=-1)


def _search_chunk(packed, verts, vmask, gvec, grad, tvec, pvec, vert_cvec,
                  wpm1):
    """The host path's device test: verts [G, T, 3] ray indices, vert_cvec
    [G, T, 3, 3] their pixel centres; returns hit [G, T], ix, iy."""
    npos = _chord(_gather_vec(packed, 0, verts), _gather_vec(packed, 3, verts),
                  grad[:, None, None], wpm1)
    return _barycentric(npos, grad[:, None, None], gvec, tvec, pvec, vmask,
                        vert_cvec)


def _interp_A_at(ivec, grad, wpm1, wpm2, pix4, wgt4, cvec4, packed):
    """interp_invmagmat_to_point: 4-ray bilinear A at image positions.

    ivec [N, 3] (need not be unit), pix4/wgt4 [N, 4] ray indices and
    weights, cvec4 [N, 4, 3] pixel centres."""
    n = _gather_vec(packed, 0, pix4)
    beta = _gather_vec(packed, 3, pix4)
    A = _gather_mat(packed, 6, pix4)
    Aprev = _gather_mat(packed, 10, pix4)
    npos, Ap = _rayprop_gs(n, beta, A, Aprev, grad[:, None], wpm1, wpm2)
    Ac = paratrans_tangtensor(Ap, npos, cvec4)
    iv = ivec / torch.linalg.vector_norm(ivec, dim=-1, keepdim=True)
    Ai = paratrans_tangtensor(Ac, cvec4, iv[:, None, :])
    return (Ai * wgt4[..., None, None]).sum(dim=1)


def _to_radec_basis(Aimg):
    """theta-phi -> ra-dec basis (gridsearch.c:800-806), host arrays."""
    Ard = np.empty_like(Aimg)
    Ard[:, 0, 0] = Aimg[:, 1, 1]
    Ard[:, 0, 1] = -Aimg[:, 1, 0]
    Ard[:, 1, 0] = -Aimg[:, 0, 1]
    Ard[:, 1, 1] = Aimg[:, 0, 0]
    return Ard


def find_images(cfg, tables: GridSearchTables, packed, gal_pos, gal_index,
                wpm1, wpm2, chunk=1024, nest2index=None):
    """All lensed images of the given source galaxies with the candidate
    prep on the host (the fallback path); gal_pos [G, 3] comoving, packed
    the [21, N] ray tensor.  nest2index: [npix] host array mapping a ray's
    NEST pixel to its index in packed, -1 where there is no ray (None =
    rays stored in NEST order; the driver stores the full sky in RING
    order and passes ring_of_nest)."""
    packed = torch.as_tensor(packed)
    dev, nd = packed.device, _np_dtype(packed.dtype)
    G = len(gal_pos)
    if G == 0:
        return _no_images()

    gal_pos = np.asarray(gal_pos, np.float64)
    grad_all = np.linalg.norm(gal_pos, axis=1)
    gvec_all = gal_pos / grad_all[:, None]
    wpm1j, wpm2j = _scalar(wpm1, packed), _scalar(wpm2, packed)
    tol = 1e-3 * np.sqrt(4.0 * np.pi / len(tables.ring_of_nest))

    out = []
    for i0 in range(0, G, chunk):
        gvec = gvec_all[i0: i0 + chunk]
        grad = grad_all[i0: i0 + chunk]
        gidx = np.asarray(gal_index)[i0: i0 + chunk]
        Gc = len(gvec)

        cand_ring = _gal_candidates(tables, gvec)          # [Gc, C]
        tri = tables.tri_nest[cand_ring]                   # [Gc, C, 4, 3] nest
        tri = tri.reshape(Gc, -1, 3)                       # [Gc, T, 3]
        vmask_h = tri[:, :, 0] >= 0
        verts_h = np.where(tri >= 0, tri, 0)
        vert_cvec_h = hp.pix2vec_nest(verts_h.reshape(-1), cfg.rayOrder
                                      ).reshape(Gc, -1, 3, 3)
        verts_idx = verts_h if nest2index is None else nest2index[verts_h]
        # cut-sky buffers mark absent pixels with -1: their triangles are
        # invalid (no ray exists there to test against)
        vmask_h = vmask_h & np.all(verts_idx >= 0, axis=-1)
        verts_idx = np.maximum(verts_idx, 0)

        tv, pv = _tvec(gvec), _pvec(gvec)
        hit, ix, iy = _search_chunk(
            packed, _upload(verts_idx, np.int64, dev),
            _upload(vmask_h, bool, dev), _upload(gvec, nd, dev),
            _upload(grad, nd, dev), _upload(tv, nd, dev),
            _upload(pv, nd, dev), _upload(vert_cvec_h, nd, dev), wpm1j)
        gi, ti = np.nonzero(hit.cpu().numpy())
        if len(gi) == 0:
            continue
        ixh = ix.cpu().numpy()[gi, ti]
        iyh = iy.cpu().numpy()[gi, ti]
        # dedup: a source on a shared triangle edge or vertex registers in
        # several triangles with near-identical image positions
        gi, ixh, iyh = _dedup_hits(gi, ixh, iyh, tol)
        ivec = gvec[gi] + ixh[:, None] * tv[gi] + iyh[:, None] * pv[gi]

        theta, phi = hp.vec2ang(ivec)
        pix4, wgt4 = hp.get_interpol(theta, phi, cfg.rayOrder)
        pix4_nest = tables.nest_of_ring[pix4]
        pix4_idx = pix4_nest if nest2index is None else nest2index[pix4_nest]
        if nest2index is not None:
            # absent interpolation neighbours (images at a patch boundary):
            # dropped, the bilinear weights renormalised
            present = pix4_idx >= 0
            pix4_idx = np.maximum(pix4_idx, 0)
            wgt4 = np.where(present, wgt4, 0.0)
            ws = wgt4.sum(axis=-1, keepdims=True)
            wgt4 = wgt4 / np.where(ws > 0, ws, 1.0)
        cvec4 = hp.pix2vec_nest(pix4_nest.reshape(-1), cfg.rayOrder
                                ).reshape(-1, 4, 3)
        Aimg = _interp_A_at(
            _upload(ivec, nd, dev), _upload(grad_all[i0 + gi], nd, dev),
            wpm1j, wpm2j, _upload(pix4_idx, np.int64, dev),
            _upload(wgt4, nd, dev), _upload(cvec4, nd, dev), packed)
        ra, dec = hp.vec2radec(ivec)
        out.append((gidx[gi], ra, dec,
                    _to_radec_basis(Aimg.cpu().double().numpy())))
    return _concat(out)


# ----------------------------------------------------------------------------
# device-resident search (RING-ordered ray grid, full sky or a box)
# ----------------------------------------------------------------------------

def search_windows(ray_order: int):
    """(nring_w, nphi_w) from the reference's search radius
    galImageSearchRad = max(10 * pixscale, 2.5 arcmin) (config.c:222-226)."""
    nside = 1 << ray_order
    pixscale = np.sqrt(4.0 * np.pi / hp.order2npix(ray_order))
    rad = max(10.0 * pixscale, 2.5 / 60.0 / 180.0 * np.pi)
    nring_w = int(np.ceil(rad / (np.pi / (4.0 * nside)))) + 2
    nphi_w = int(np.ceil(rad / (2.0 * np.pi / (4.0 * nside)))) + 2
    return nring_w, nphi_w


def _rows_of_pix(ring_rows, pix):
    """Global RING pixels -> rows of a CUT-SKY ray buffer.

    ring_rows: int64 [N] on the device, the sorted RING pixel of each ray
    row (a box's pixels in RING order, driver.active_ray_pixels).  Returns
    (rows, present): rows are valid buffer rows (clamped for absent
    pixels), present marks the pixels that have a ray.  A triangle with an
    absent vertex is invalid: the reference searches only the rays that
    exist in the patch (gridsearch.c:24-192)."""
    N = ring_rows.shape[0]
    rows = torch.clamp(torch.searchsorted(ring_rows, pix.long()), 0, N - 1)
    return rows, ring_rows[rows] == pix


def _bary_search(tab, topk, packed, gvec, grad, tvec, pvec, wpm1,
                 ring_rows=None):
    """Device candidate prep and barycentric test for one galaxy chunk.

    Candidates come from a ring/phi window around each galaxy
    (torchhp.ring_window, ring arithmetic only), cut to the topk pixels
    whose CENTRES lie nearest the galaxy (ray i of the grid sits within its
    accumulated deflection of pixel centre i), by a stable descending sort:
    ties keep the lower window index first, as jax.lax.top_k does.  Only
    those pixels' triangles gather their rays' (n, beta).  Returns (hit
    [G, T], ix, iy) with T = 4 topk."""
    dtype = packed.dtype
    G = gvec.shape[0]
    theta, phi = torchhp.vec2ang(gvec)
    nring_w, nphi_w = search_windows(tab.order)
    pixw, valid = torchhp.ring_window(tab, theta, phi, nring_w, nphi_w)
    pixf = pixw.reshape(G, -1)
    cx, cy, cz = torchhp.pix2vec_ring_soa(pixf, tab.order, dtype)
    score = cx * gvec[:, 0:1] + cy * gvec[:, 1:2] + cz * gvec[:, 2:3]
    score = torch.where(valid.reshape(G, -1), score, -2.0)
    sel = torch.sort(score, dim=1, descending=True, stable=True).indices
    cand = torch.gather(pixf, 1, sel[:, :topk])

    tri = torchhp.triangles_ring(tab, cand).reshape(G, -1, 3)  # [G, T, 3]
    vmask = tri[:, :, 0] >= 0
    verts = torch.clamp(tri, min=0).long()            # global ray pixels
    if ring_rows is None:
        rows = torch.clamp(verts, max=packed.shape[1] - 1)
    else:
        rows, present = _rows_of_pix(ring_rows, verts)
        vmask = vmask & present.all(dim=-1)

    # exact test on the deformed grid: candidate vertices propagated to the
    # galaxy radius (positions only; A is gathered per hit later)
    wp = grad[:, None, None]
    npos = _chord(_gather_vec(packed, 0, rows), _gather_vec(packed, 3, rows),
                  wp, wpm1)
    vert_cvec = torchhp.pix2vec_ring(verts, tab.order, dtype)
    return _barycentric(npos, wp, gvec, tvec, pvec, vmask, vert_cvec)


def _dedup_rows_device(hit, ix, iy, tol):
    """Greedy per-galaxy dedup on the device (_dedup_hits' analog): walk
    each galaxy's T triangle hits in row order and keep a hit only if it
    is >= tol away (in ix OR iy) from every previously KEPT hit."""
    near = (((ix[:, :, None] - ix[:, None, :]).abs() < tol)
            & ((iy[:, :, None] - iy[:, None, :]).abs() < tol)
            & hit[:, None, :])                         # [G, j, k]
    keep = torch.zeros_like(hit)
    for j in range(hit.shape[1]):
        keep[:, j] = hit[:, j] & ~(near[:, j, :j] & keep[:, :j]).any(dim=1)
    return keep


def _compact(flat, size):
    """Indices of the first `size` True entries of flat, 0-filled
    (jnp.nonzero(flat, size=size, fill_value=0)), by a cumulative sum and a
    scatter: no host sync, unlike torch.nonzero."""
    pos = torch.cumsum(flat, 0) - 1
    dest = torch.where(flat & (pos < size), pos, size)
    out = torch.zeros(size + 1, dtype=torch.long, device=flat.device)
    out.scatter_(0, dest, torch.arange(flat.numel(), device=flat.device))
    return out[:size]


def _search_images_chunk(tab, packed, topk, maxh, gvec, grad, tvec, pvec,
                         wpm1, wpm2, tol, ring_rows=None):
    """Search and post-processing of one galaxy chunk on the device:
    barycentric search, per-galaxy dedup, compaction into maxh slots, A
    interpolated and transported to the images, ra-dec output.

    Returns (count, gi, ra, dec, A_rd [4, maxh]), all on the device; rows
    >= count are padding.  count can exceed maxh: the caller must then
    fall back."""
    dtype = packed.dtype
    hit, ix, iy = _bary_search(tab, topk, packed, gvec, grad, tvec, pvec,
                               wpm1, ring_rows=ring_rows)
    keep = _dedup_rows_device(hit, ix, iy, tol)
    T = keep.shape[1]
    flat = keep.reshape(-1)
    count = flat.sum()
    idx = _compact(flat, maxh)
    gi = torch.div(idx, T, rounding_mode="floor")
    ixh = ix.reshape(-1)[idx]
    iyh = iy.reshape(-1)[idx]

    ivec = gvec[gi] + ixh[:, None] * tvec[gi] + iyh[:, None] * pvec[gi]
    theta, phi = _image_angles(ivec)
    pix4, wgt4 = torchhp.get_interpol(tab, theta, phi)
    cvec4 = torchhp.pix2vec_ring(pix4, tab.order, dtype)
    wgt4 = wgt4.to(dtype)
    if ring_rows is not None:
        # cut sky: interpolation neighbours with no ray (images within one
        # pixel of the patch boundary) drop out, the rest renormalise
        pix4, present = _rows_of_pix(ring_rows, pix4)
        wgt4 = torch.where(present, wgt4, 0.0)
        wsum = wgt4.sum(dim=-1, keepdim=True)
        wgt4 = wgt4 / torch.where(wsum > 0, wsum, 1.0)
    Aimg = _interp_A_at(ivec, grad[gi], wpm1, wpm2, pix4, wgt4, cvec4, packed)
    # theta-phi -> ra-dec basis (gridsearch.c:800-806)
    A_rd = torch.stack([Aimg[:, 1, 1], -Aimg[:, 1, 0],
                        -Aimg[:, 0, 1], Aimg[:, 0, 0]])
    return count, gi, torch.rad2deg(phi), 90.0 - torch.rad2deg(theta), A_rd


def _image_angles(ivec):
    """(theta, phi) of image vectors [N, 3]: theta = atan2(rho, z), whose
    rounding stays relative next to the poles, where arccos(z / r) in
    float32 is off by ~eps / sin(theta) (ROADMAP Queue 3)."""
    x, y, z = ivec[:, 0], ivec[:, 1], ivec[:, 2]
    theta = torch.atan2(torch.sqrt(x * x + y * y), z)
    phi = torch.atan2(y, x)
    return theta, torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)


def find_images_device_async(cfg, tab, packed, gal_pos, gal_index, wpm1,
                             wpm2, chunk=16384, topk=16, ring_rows=None):
    """Queue the device search of every chunk; returns a zero-argument
    collect() that reads the hits.

    Nothing here waits for the device: the galaxies go up once through
    pinned memory, and the hit count of each chunk stays a device tensor
    until collect().  The driver queues the search, then the plane step,
    then collects (the reference serialises the search before the Poisson
    solve, raytrace.c:205-241).  packed is the RING-ordered [21, N] ray
    tensor: the full sky (ray i at RING pixel i, tab.npix rays) or, with
    ring_rows, the sorted RING pixel of each row of a box."""
    G = len(gal_pos)
    if G == 0:
        return _no_images
    dev, nd = packed.device, _np_dtype(packed.dtype)
    gal_pos = np.asarray(gal_pos, np.float64)
    grad_all = np.linalg.norm(gal_pos, axis=1)
    gvec_all = gal_pos / grad_all[:, None]
    gvec, grad, tvec, pvec = (_upload(a, nd, dev) for a in (
        gvec_all, grad_all, _tvec(gvec_all), _pvec(gvec_all)))
    rr = None if ring_rows is None else _upload(ring_rows, np.int64, dev)
    wpm1j, wpm2j = _scalar(wpm1, packed), _scalar(wpm2, packed)
    tol = _scalar(1e-3 * np.sqrt(4.0 * np.pi / tab.npix), packed)

    # hit budget per chunk: ~1 image per galaxy in the weak-lensing regime
    # (shared-edge duplicates are removed before the compaction); the
    # compaction and interpolation cost grows with maxh, used or not;
    # overflow falls back in collect()
    maxh = 2 * chunk
    pend = []
    for i0 in range(0, G, chunk):
        sl = slice(i0, i0 + chunk)
        pend.append((i0, _search_images_chunk(
            tab, packed, topk, maxh, gvec[sl], grad[sl], tvec[sl], pvec[sl],
            wpm1j, wpm2j, tol, rr)))

    gal_index = np.asarray(gal_index)
    return lambda: _collect_device_hits(cfg, tab, packed, pend, gal_pos,
                                        gal_index, wpm1, wpm2, chunk, maxh,
                                        ring_rows=ring_rows)


def _fallback_tables(order, ring_rows):
    """The host search's tables and its NEST pixel -> buffer row map: the
    full sky's ring_of_nest, or for a box -1 where no ray is."""
    tables = GridSearchTables(order)
    if ring_rows is None:
        return tables, tables.ring_of_nest
    n2i = np.full(len(tables.ring_of_nest), -1, np.int64)
    n2i[tables.nest_of_ring[np.asarray(ring_rows)]] = np.arange(len(ring_rows))
    return tables, n2i


def _collect_device_hits(cfg, tab, packed, pend, gal_pos, gal_index, wpm1,
                         wpm2, chunk, maxh, ring_rows=None):
    """The queued chunks' hits -> ImageGals on the host.  A chunk whose
    count overflowed its maxh slots is searched again by find_images on
    `packed`.  The plane step never writes into the ray buffer it is given
    (soa.zero_plane_rows copies), so this pre-step buffer is alive here
    whatever ran since the dispatch; the JAX package's snapshot copy and
    its abort on a donated buffer have no counterpart."""
    out = []
    fallback = None
    counts = torch.stack([res[0] for _, res in pend]).cpu().tolist()
    for (i0, (_, gi, ra, dec, A_rd)), n in zip(pend, counts):
        if n == 0:
            continue
        if n > maxh:
            if fallback is None:
                fallback = _fallback_tables(tab.order, ring_rows)
            tables, n2i = fallback
            sl = slice(i0, min(i0 + chunk, len(gal_pos)))
            out.append(find_images(cfg, tables, packed, gal_pos[sl],
                                   gal_index[sl], wpm1, wpm2,
                                   nest2index=n2i))
            continue
        Ah = A_rd[:, :n].cpu().double().numpy()
        out.append((gal_index[i0 + gi[:n].cpu().numpy()],
                    ra[:n].cpu().double().numpy(),
                    dec[:n].cpu().double().numpy(),
                    Ah.T.reshape(n, 2, 2)))
    return _concat(out)


def find_images_device(cfg, tab, packed, gal_pos, gal_index, wpm1, wpm2,
                       chunk=16384, topk=16, ring_rows=None):
    """The device search for RING-ordered rays, queued and collected.
    Full sky: ray index == RING pixel (the driver's full-sky storage).
    Cut sky: ring_rows, the sorted RING pixel of each ray row; the
    candidate taps are translated to rows on the device (searchsorted), so
    a box gets the full sky's path (reference gridsearch.c:24-192 serves
    any sky selection)."""
    return find_images_device_async(cfg, tab, packed, gal_pos, gal_index,
                                    wpm1, wpm2, chunk=chunk, topk=topk,
                                    ring_rows=ring_rows)()


def find_images_born(cfg, tab, packed, gal_pos, gal_index, wpm1, wpm2,
                     chunk=1 << 20):
    """BORNAPPRX grid search (gridsearch.c:316-414): no triangle search;
    A interpolated at each galaxy's undeflected position (full-sky
    RING-ordered rays)."""
    dev, nd = packed.device, _np_dtype(packed.dtype)
    G = len(gal_pos)
    if G == 0:
        return _no_images()
    gal_pos = np.asarray(gal_pos, np.float64)
    grad_all = np.linalg.norm(gal_pos, axis=1)
    gvec_all = gal_pos / grad_all[:, None]
    wpm1j, wpm2j = _scalar(wpm1, packed), _scalar(wpm2, packed)

    out = []
    for i0 in range(0, G, chunk):
        gvec = gvec_all[i0: i0 + chunk]
        grad = grad_all[i0: i0 + chunk]
        theta, phi = hp.vec2ang(gvec)
        pix4, wgt4 = hp.get_interpol(theta, phi, cfg.rayOrder)
        cvec4 = hp.pix2vec_ring(pix4.reshape(-1), cfg.rayOrder
                                ).reshape(-1, 4, 3)
        Aimg = _interp_A_at(
            _upload(gvec, nd, dev), _upload(grad, nd, dev), wpm1j, wpm2j,
            _upload(pix4, np.int64, dev), _upload(wgt4, nd, dev),
            _upload(cvec4, nd, dev), packed)
        out.append(Aimg.cpu().double().numpy())
    ra, dec = hp.vec2radec(gvec_all)
    return ImageGals(np.asarray(gal_index, np.int64).copy(), ra, dec,
                     _to_radec_basis(np.concatenate(out)))


def _dedup_hits(gi, ixh, iyh, tol):
    """Greedy near-duplicate removal (shared-edge double hits); compares
    against the last KEPT row within each sorted run."""
    order = np.lexsort((iyh, ixh, gi))
    gs, xs, ys = gi[order], ixh[order], iyh[order]
    near_prev = np.zeros(len(gs), bool)
    near_prev[1:] = ((np.diff(gs) == 0)
                     & (np.abs(np.diff(xs)) < tol)
                     & (np.abs(np.diff(ys)) < tol))
    keep_sorted = ~near_prev
    (run_rows,) = np.nonzero(near_prev)
    last_x, last_y, run_start = 0.0, 0.0, -2
    for r in run_rows:
        if r - 1 != run_start:
            last_x, last_y = xs[r - 1], ys[r - 1]
        if abs(xs[r] - last_x) >= tol or abs(ys[r] - last_y) >= tol:
            keep_sorted[r] = True
            last_x, last_y = xs[r], ys[r]
        run_start = r
    keep = np.ones(len(gi), bool)
    keep[order] = keep_sorted
    return gi[keep], ixh[keep], iyh[keep]


def _pvec(gvec):
    npv = np.hypot(gvec[:, 0], gvec[:, 1])
    return np.stack([-gvec[:, 1] / npv, gvec[:, 0] / npv,
                     np.zeros(len(gvec))], axis=1)


def _tvec(gvec):
    npv = np.hypot(gvec[:, 0], gvec[:, 1])
    return np.stack([gvec[:, 2] * gvec[:, 0] / npv,
                     gvec[:, 2] * gvec[:, 1] / npv,
                     -(gvec[:, 0] ** 2 + gvec[:, 1] ** 2) / npv], axis=1)


def select_plane_gals(gal_pos, gal_index, plane_num, binL, num_planes,
                      max_comv):
    """Gals whose radial bin is the current plane (gridsearch.c:39-79)."""
    rad = np.linalg.norm(np.asarray(gal_pos, np.float64), axis=1)
    bind = (rad / binL).astype(np.int64)
    at_edge = (bind == num_planes) & (np.abs(rad - max_comv) < 1e-3)
    bind = np.where(at_edge, num_planes - 1, bind)
    sel = bind == plane_num
    return np.asarray(gal_pos)[sel], np.asarray(gal_index)[sel]
