// The ray side of one lens plane, f32: the 4-tap interpolation of the six
// field maps with parallel transport, then the propagation to the next
// plane, for every ray in one pass.
//
// Replaces no TPU kernel: the JAX package's ray side (calclens_tpu/rays/
// soa.py) is XLA.  It replaces, on the card, the eager PyTorch chain of
// rays/soa.py, kept as its plain twin: chunked_into over
// interp_and_prop_chunk -> get_interpol_soa, _finish_from_fields ->
// _prop_rows, which runs each column chunk as hundreds of elementwise
// launches, every intermediate written to and read from device memory.
//
//   packed [21, N]  rows 0-13 read (n, beta, A, A_prev); rows 14-20 (alpha,
//                   U, phi) are taken as zero, as zero_plane_rows makes
//                   them; packed itself is not written
//   maps7  [7, W]   the six maps (pot, gt, gp, gtt, gtp, gpp) and the pixel
//                   ids (soa.pixel_id_row: int32 id | 0x40000000 as f32
//                   bits) of a window of W pixels from global pixel pix_base
//   wp, wpm1, wpm2  0-d device scalars: the next, current, previous radius
//   out    [21, N]  the new state, every row
//
// One thread per ray: the ray's unit vector, theta and phi; its four taps
// (get_interpol_soa), each clamped into the window; per tap the six fields
// and the pixel id gathered, the tap's ring geometry, azimuth offset and
// transport angle rebuilt from that id (so each weight is paired with the
// field it was computed for); the weights with the pole folds; the sums of
// pot, alpha and U; the born or full propagation (_prop_rows).
//
// Rounding: the kernel computes what the twin computes on the card,
// operation by operation.  Every product, sum, quotient and square root is
// written __f*_rn, so nvcc contracts nothing into an FMA; the libm calls
// are those of PyTorch's CUDA kernels (acosf, asinf, atan2f, sinf, cosf,
// nearbyintf, floorf); ATen's own roundings are followed: a tensor divided
// by a Python number is multiplied by the number's float reciprocal, 1 / t
// is a correctly rounded reciprocal, Python constants are rounded to float,
// torch.clamp lets NaN through, torch.sign is (0 < x) - (x < 0).  Where the
// twin's torch.where keeps one of two branches, only that branch is
// computed: its value is the same.  Integer work is 64-bit, as the twin's.
//
// What bounds it on the H100: device memory.  A ray reads 14 rows and
// writes 21 (140 B); its 4 taps x 7 rows hit L2 (about 16 rays share each
// NSIDE 4096 pixel in RING order).  At 17,179,370 rays that is 2.4 GB,
// 0.72 ms at 3.35 TB/s.  The transcendentals (acos, atan2, per tap an
// asin or acos and two sin/cos pairs, sin and cos of |alpha|) and the
// correctly rounded divisions are the arithmetic's cost.  Design: one launch
// over all N columns, rows read and written coalesced (consecutive threads,
// consecutive columns), taps through the read-only cache; nothing is
// staged, nothing is reduced across threads.

#include <cuda_runtime.h>

#include <cmath>

namespace {

typedef long long i64;

constexpr int kThreads = 256;

// Python constants as ATen takes them: rounded to float.
constexpr float kTwoPi = static_cast<float>(6.283185307179586);
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kTwoThirds = static_cast<float>(2.0 / 3.0);
constexpr float kFourThirds = static_cast<float>(4.0 / 3.0);

__device__ __forceinline__ float fm(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fa(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fs(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fd(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float fsq(float a) { return __fsqrt_rn(a); }
// torch.reciprocal (1.0 / t)
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }

// torch.clamp / clamp(min=): NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ i64 clampl(i64 v, i64 lo, i64 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Exact integer sqrt for 0 <= x < 2^31 (torchhp._isqrt_dev).
__device__ __forceinline__ i64 isqrt(i64 x) {
  i64 r = static_cast<i64>(fsq(static_cast<float>(x)));
  if ((r + 1) * (r + 1) <= x) r += 1;
  if (r * r > x) r -= 1;
  return r;
}

// torchhp._ring_layout: first pixel, pixels and shift flag of ring ir.
__device__ __forceinline__ void ring_layout(i64 ir, i64 nside, i64 npix,
                                            i64& sp, i64& nr, bool& shifted) {
  const bool north = ir < nside;
  const bool south = ir > 3 * nside;
  const i64 isouth = 4 * nside - ir;
  nr = 4 * (north ? ir : (south ? isouth : nside));
  const i64 ncap = 2 * nside * (nside - 1);
  sp = north ? 2 * ir * (ir - 1)
             : (south ? npix - 2 * isouth * (isouth + 1)
                      : ncap + (ir - nside) * (4 * nside));
  shifted = north || south || (((ir + nside) & 1) == 0);
}

// torchhp._ring_geo_closed's theta of ring ir.
__device__ __forceinline__ float ring_theta(i64 ir, i64 nside, float half,
                                            float inv_3nside) {
  const float irf = static_cast<float>(ir);
  if (ir < nside) return fm(2.0f, asinf(clampf(fm(irf, half), 0.0f, 1.0f)));
  if (ir > 3 * nside) {
    const float isf = static_cast<float>(4 * nside - ir);
    return fs(kPi, fm(2.0f, asinf(clampf(fm(isf, half), 0.0f, 1.0f))));
  }
  const float zb = fs(kFourThirds, fm(fm(2.0f, irf), inv_3nside));
  return acosf(clampf(zb, -1.0f, 1.0f));
}

// 2 pi / nr as ATen forms it: reciprocal(nr) * float(2 pi).
__device__ __forceinline__ float ring_dphi(i64 nr) {
  return fm(rcp(static_cast<float>(nr)), kTwoPi);
}

// get_interpol_soa's ring_interp: the two taps of ring ir (clamped).
__device__ __forceinline__ void ring_interp(i64 ir, float phi, i64 nside,
                                            i64 npix, i64& p1, i64& p2) {
  i64 sp, nr;
  bool shifted;
  ring_layout(clampl(ir, 1, 4 * nside - 1), nside, npix, sp, nr, shifted);
  const float tmp = fs(fd(phi, ring_dphi(nr)), shifted ? 0.5f : 0.0f);
  i64 i1 = static_cast<i64>(floorf(tmp));
  i64 i2 = i1 + 1;
  if (i1 < 0) i1 += nr;
  if (i2 >= nr) i2 -= nr;
  p1 = sp + i1;
  p2 = sp + i2;
}

// torchhp.ring_decode_pix: RING pixel -> (ring 1..4nside-1, index in ring).
__device__ __forceinline__ void ring_decode(i64 pk, i64 nside, i64 npix,
                                            i64& ring, i64& idx) {
  const i64 ncap = 2 * nside * (nside - 1);
  if (pk < ncap) {
    ring = (1 + isqrt(1 + 2 * pk)) >> 1;
    idx = pk - 2 * ring * (ring - 1);
  } else if (pk >= npix - ncap) {
    const i64 ip_s = npix - pk;
    const i64 a = 2 * ip_s - 1;
    const i64 ir_sl = (1 + isqrt(a < 1 ? 1 : a)) >> 1;
    idx = 2 * ir_sl * (ir_sl + 1) - ip_s;
    ring = 4 * nside - ir_sl;
  } else {
    const i64 ip_e = pk - ncap;
    const i64 q = 4 * nside;
    i64 t = ip_e / q;
    if ((ip_e % q != 0) && ((ip_e < 0) != (q < 0))) t -= 1;  // floor
    ring = t + nside;
    idx = ip_e - t * q;
  }
}

// soa._transport_psi: cos/sin of the transport angle from unit v to unit r.
__device__ __forceinline__ void transport_psi(float vx, float vy, float vz,
                                              float rx, float ry, float rz,
                                              float& c, float& s) {
  float ax = fs(fm(vy, rz), fm(vz, ry));
  float ay = fs(fm(vz, rx), fm(vx, rz));
  float az = fs(fm(vx, ry), fm(vy, rx));
  const float cosang = fa(fa(fm(vx, rx), fm(vy, ry)), fm(vz, rz));
  const float sinang = fsq(fa(fa(fm(ax, ax), fm(ay, ay)), fm(az, az)));
  const bool safe = sinang > 0.0f;
  const float inv = rcp(safe ? sinang : 1.0f);
  ax = safe ? fm(ax, inv) : 1.0f;
  ay = safe ? fm(ay, inv) : 0.0f;
  az = safe ? fm(az, inv) : 0.0f;
  const float px = -vy, py = vx;
  const float adotp = fa(fm(ax, px), fm(ay, py));
  const float cx = fm(-az, py);
  const float cy = fm(az, px);
  const float cz = fs(fm(ax, py), fm(ay, px));
  const float omc = fs(1.0f, cosang);
  const float qx = fa(fa(fm(px, cosang), fm(fm(ax, adotp), omc)),
                      fm(cx, sinang));
  const float qy = fa(fa(fm(py, cosang), fm(fm(ay, adotp), omc)),
                      fm(cy, sinang));
  const float qz = fa(fm(fm(az, adotp), omc), fm(cz, sinang));
  const float ephx = -ry, ephy = rx;
  const float etx = fm(rz, rx), ety = fm(rz, ry);
  const float etz = -fa(fm(rx, rx), fm(ry, ry));
  const float norm = fsq(fm(fm(fm(fs(1.0f, rz), fa(rz, 1.0f)), fs(1.0f, vz)),
                            fa(vz, 1.0f)));
  const float inv2 = rcp(norm > 0.0f ? norm : 1.0f);
  const float sinpsi = fm(fa(fa(fm(qx, etx), fm(qy, ety)), fm(qz, etz)), inv2);
  const float cospsi = fm(fa(fm(qx, ephx), fm(qy, ephy)), inv2);
  const bool same = sinang == 0.0f;
  c = same ? 1.0f : cospsi;
  s = same ? 0.0f : sinpsi;
}

// soa._rot_tensor: R^T T R with R = [[c, -s], [s, c]].
__device__ __forceinline__ void rot_tensor(float c, float s, float t00,
                                           float t01, float t10, float t11,
                                           float& o00, float& o01, float& o10,
                                           float& o11) {
  const float a = fa(fm(t00, c), fm(t01, s));
  const float b = fa(fm(-t00, s), fm(t01, c));
  const float d = fa(fm(t10, c), fm(t11, s));
  const float e = fa(fm(-t10, s), fm(t11, c));
  o00 = fa(fm(c, a), fm(s, d));
  o01 = fa(fm(c, b), fm(s, e));
  o10 = fa(fm(-s, a), fm(c, d));
  o11 = fa(fm(-s, b), fm(c, e));
}

// _finish_from_fields' az_pair: linear weights of two taps at signed
// azimuth offsets d0, d1.
__device__ __forceinline__ void az_pair(float d0, float d1, float& a0,
                                        float& a1) {
  const float span = fs(d1, d0);
  const bool safe = fabsf(span) > 1e-30f;
  const float inv = rcp(safe ? span : 1.0f);
  a0 = safe ? fm(d1, inv) : 0.5f;
  a1 = fs(1.0f, a0);
}

template <bool kBorn>
__global__ void __launch_bounds__(kThreads)
rayside_kernel(const float* __restrict__ packed,
               const float* __restrict__ maps7,
               const float* __restrict__ wp_p,
               const float* __restrict__ wpm1_p,
               const float* __restrict__ wpm2_p, float* __restrict__ out,
               i64 N, i64 W, i64 pix_base, i64 nside, float half) {
  const i64 i = static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= N) return;
  const i64 npix = 12 * nside * nside;
  const i64 nrings = 4 * nside - 1;
  const float inv_2pi = rcp(kTwoPi);
  const float inv_3nside = rcp(static_cast<float>(3 * nside));

  const float* r = packed + i;
  const float nx = r[0], ny = r[N], nz = r[2 * N];

  // the ray's direction (interp_and_prop_chunk)
  const float rad = fsq(fa(fa(fm(nx, nx), fm(ny, ny)), fm(nz, nz)));
  const float hx = fd(nx, rad), hy = fd(ny, rad), hz = fd(nz, rad);
  const float theta = acosf(clampf(hz, -1.0f, 1.0f));
  float phi = atan2f(hy, hx);
  if (phi < 0.0f) phi = fa(phi, kTwoPi);

  // the four taps (get_interpol_soa)
  i64 pix[4];
  {
    const float z = cosf(theta);
    const float az = fabsf(z);
    const float fn = static_cast<float>(nside);
    i64 ring_above;
    if (az <= kTwoThirds) {
      ring_above = static_cast<i64>(fm(fn, fs(2.0f, fm(1.5f, z))));
    } else {
      const i64 ir_cap = static_cast<i64>(
          fm(fn, fsq(clamp_min(fm(3.0f, fs(1.0f, az)), 0.0f))));
      ring_above = z > 0.0f ? ir_cap : 4 * nside - ir_cap - 1;
    }
    i64 p11, p12, p21, p22;
    ring_interp(ring_above, phi, nside, npix, p11, p12);
    ring_interp(ring_above + 1, phi, nside, npix, p21, p22);
    const bool north = ring_above == 0;
    const bool south = ring_above + 1 == 4 * nside;
    pix[0] = north ? (((p21 + 2) % 4) + 4) % 4 : p11;
    pix[1] = north ? (((p22 + 2) % 4) + 4) % 4 : p12;
    pix[2] = south ? ((p11 + 2) & 3) + npix - 4 : p21;
    pix[3] = south ? ((p12 + 2) & 3) + npix - 4 : p22;
  }

  // per tap: the fields, the id, the geometry rebuilt from the id
  float fld[4][6], dl[4], th[4], cs[4], sn[4];
  i64 rg[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const i64 q = clampl(pix[k] - pix_base, 0, W - 1);
#pragma unroll
    for (int j = 0; j < 6; ++j) fld[k][j] = __ldg(maps7 + j * W + q);
    const i64 pid = __float_as_int(__ldg(maps7 + 6 * W + q)) & 0x3FFFFFFF;
    i64 ring, idx;
    ring_decode(pid, nside, npix, ring, idx);
    i64 sp, nr;
    bool shifted;
    ring_layout(ring, nside, npix, sp, nr, shifted);
    const float thr = ring_theta(ring, nside, half, inv_3nside);
    const float phic = fm(fa(static_cast<float>(idx), shifted ? 0.5f : 0.0f),
                          ring_dphi(nr));
    float delta = fs(phi, phic);
    delta = fs(delta, fm(kTwoPi, nearbyintf(fm(delta, inv_2pi))));
    const float sthr = sinf(thr);
    transport_psi(fm(sthr, cosf(phic)), fm(sthr, sinf(phic)), cosf(thr), hx,
                  hy, hz, cs[k], sn[k]);
    dl[k] = delta;
    th[k] = thr;
    rg[k] = ring;
  }

  // the weights and the pole folds
  float a0, a1, a2, a3;
  az_pair(dl[0], dl[1], a0, a1);
  az_pair(dl[2], dl[3], a2, a3);
  const float span_t = fs(th[2], th[0]);
  const bool safe_t = fabsf(span_t) > 1e-30f;
  const float wt =
      safe_t ? fd(fs(theta, th[0]), span_t) : 0.5f;  // x / 1.0 == x
  const bool same_ring = rg[0] == rg[2];
  const bool north = same_ring && rg[2] == 1;
  const bool south = same_ring && rg[0] == nrings;
  float w[4];
  if (north) {
    const float wtn = fd(theta, th[2]);
    const float facn = fm(fs(1.0f, wtn), 0.25f);
    w[0] = facn;
    w[1] = facn;
    w[2] = fa(fm(wtn, a2), facn);
    w[3] = fa(fm(wtn, a3), facn);
  } else if (south) {
    const float wts = fd(fs(theta, th[0]), fs(kPi, th[0]));
    const float facs = fm(wts, 0.25f);
    const float omw = fs(1.0f, wts);
    w[0] = fa(fm(omw, a0), facs);
    w[1] = fa(fm(omw, a1), facs);
    w[2] = facs;
    w[3] = facs;
  } else {
    const float omt = fs(1.0f, wt);
    w[0] = fm(omt, a0);
    w[1] = fm(omt, a1);
    w[2] = fm(wt, a2);
    w[3] = fm(wt, a3);
  }

  // pot, the gradient and the Hessian, transported to the ray
  float pot = 0.0f, g0 = 0.0f, g1 = 0.0f;
  float u00 = 0.0f, u01 = 0.0f, u10 = 0.0f, u11 = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wk = w[k], c = cs[k], s = sn[k];
    const float gt = fld[k][1], gp = fld[k][2];
    pot = fa(pot, fm(fld[k][0], wk));
    g0 = fa(g0, fm(fa(fm(gt, c), fm(gp, s)), wk));
    g1 = fa(g1, fm(fa(fm(-gt, s), fm(gp, c)), wk));
    float t00, t01, t10, t11;
    rot_tensor(c, s, fld[k][3], fld[k][4], fld[k][4], fld[k][5], t00, t01,
               t10, t11);
    u00 = fa(u00, fm(t00, wk));
    u01 = fa(u01, fm(t01, wk));
    u10 = fa(u10, fm(t10, wk));
    u11 = fa(u11, fm(t11, wk));
  }
  // alpha -= grad, U += hess on the zeroed rows
  const float al0 = fs(0.0f, g0), al1 = fs(0.0f, g1);
  const float U00 = fa(0.0f, u00), U01 = fa(0.0f, u01);
  const float U10 = fa(0.0f, u10), U11 = fa(0.0f, u11);

  // propagation (_prop_rows)
  const float wp = *wp_p, wpm1 = *wpm1_p, wpm2 = *wpm2_p;
  const float f = fd(fm(wpm1, fs(wp, wpm2)), fm(wp, fs(wpm1, wpm2)));
  const float g = fd(fs(wp, wpm1), wp);
  const float omf = fs(1.0f, f);
  const float bx = r[3 * N], by = r[4 * N], bz = r[5 * N];
  const float A00 = r[6 * N], A01 = r[7 * N], A10 = r[8 * N], A11 = r[9 * N];
  const float P00 = r[10 * N], P01 = r[11 * N], P10 = r[12 * N],
              P11 = r[13 * N];
  float UA00 = U00, UA01 = U01, UA10 = U10, UA11 = U11;
  if (!kBorn) {
    UA00 = fa(fm(U00, A00), fm(U01, A10));
    UA01 = fa(fm(U00, A01), fm(U01, A11));
    UA10 = fa(fm(U10, A00), fm(U11, A10));
    UA11 = fa(fm(U10, A01), fm(U11, A11));
  }
  const float N00 = fs(fa(fm(omf, P00), fm(f, A00)), fm(g, UA00));
  const float N01 = fs(fa(fm(omf, P01), fm(f, A01)), fm(g, UA01));
  const float N10 = fs(fa(fm(omf, P10), fm(f, A10)), fm(g, UA10));
  const float N11 = fs(fa(fm(omf, P11), fm(f, A11)), fm(g, UA11));

  float o[21];
  if (kBorn) {
    const float sc = fd(wp, wpm1);
    o[0] = fm(nx, sc); o[1] = fm(ny, sc); o[2] = fm(nz, sc);
    o[3] = bx; o[4] = by; o[5] = bz;
    o[6] = N00; o[7] = N01; o[8] = N10; o[9] = N11;
    o[10] = A00; o[11] = A01; o[12] = A10; o[13] = A11;
  } else {
    // bend beta by |alpha| about n x avec
    const float amag = fsq(fa(fm(al0, al0), fm(al1, al1)));
    const float npv = fsq(fa(fm(hx, hx), fm(hy, hy)));
    const float tinv = rcp(clamp_min(npv, 1e-30f));
    const float phx = fm(-hy, tinv), phy = fm(hx, tinv);
    const float thx = fm(fm(hz, hx), tinv), thy = fm(fm(hz, hy), tinv);
    const float thz = -npv;
    const float avx = fa(fm(al0, thx), fm(al1, phx));
    const float avy = fa(fm(al0, thy), fm(al1, phy));
    const float avz = fm(al0, thz);
    float axx = fs(fm(ny, avz), fm(nz, avy));
    float axy = fs(fm(nz, avx), fm(nx, avz));
    float axz = fs(fm(nx, avy), fm(ny, avx));
    const float an = fsq(fa(fa(fm(axx, axx), fm(axy, axy)), fm(axz, axz)));
    const float ainv = rcp(an > 0.0f ? an : 1.0f);
    axx = fm(axx, ainv);
    axy = fm(axy, ainv);
    axz = fm(axz, ainv);
    float bbx = bx, bby = by, bbz = bz;
    if (amag > 0.0f) {
      const float ca = cosf(amag), sa = sinf(amag);
      const float adotb = fa(fa(fm(axx, bx), fm(axy, by)), fm(axz, bz));
      const float cxx = fs(fm(axy, bz), fm(axz, by));
      const float cyy = fs(fm(axz, bx), fm(axx, bz));
      const float czz = fs(fm(axx, by), fm(axy, bx));
      const float omc = fs(1.0f, ca);
      bbx = fa(fa(fm(bx, ca), fm(fm(axx, adotb), omc)), fm(cxx, sa));
      bby = fa(fa(fm(by, ca), fm(fm(axy, adotb), omc)), fm(cyy, sa));
      bbz = fa(fa(fm(bz, ca), fm(fm(axz, adotb), omc)), fm(czz, sa));
    }
    // the geodesic chord |n + lam b| = wp
    const float qb = fm(2.0f, fa(fa(fm(nx, bbx), fm(ny, bby)), fm(nz, bbz)));
    const float qc = fs(fm(wpm1, wpm1), fm(wp, wp));
    const float disc = fsq(clamp_min(fs(fm(qb, qb), fm(4.0f, qc)), 0.0f));
    const float sgn = static_cast<float>((0.0f < qb) - (qb < 0.0f));
    const float qq = fm(-0.5f, fa(qb, fm(sgn, disc)));
    const float lam1 = fd(qc, qq != 0.0f ? qq : 1.0f);
    const float lam = lam1 < 0.0f ? qq : lam1;
    const float mx = fa(nx, fm(bbx, lam));
    const float my = fa(ny, fm(bby, lam));
    const float mz = fa(nz, fm(bbz, lam));
    // transport A and A_prev to the new position
    const float mrad = fsq(fa(fa(fm(mx, mx), fm(my, my)), fm(mz, mz)));
    float c, s;
    transport_psi(hx, hy, hz, fd(mx, mrad), fd(my, mrad), fd(mz, mrad), c, s);
    const float sc = fd(wp, mrad);
    o[0] = fm(mx, sc); o[1] = fm(my, sc); o[2] = fm(mz, sc);
    o[3] = bbx; o[4] = bby; o[5] = bbz;
    rot_tensor(c, s, N00, N01, N10, N11, o[6], o[7], o[8], o[9]);
    rot_tensor(c, s, A00, A01, A10, A11, o[10], o[11], o[12], o[13]);
  }
  o[14] = al0; o[15] = al1;
  o[16] = U00; o[17] = U01; o[18] = U10; o[19] = U11;
  o[20] = pot;
  float* dst = out + i;
#pragma unroll
  for (int k = 0; k < 21; ++k) dst[k * N] = o[k];
}

}  // namespace

// packed [21, N], maps7 [7, W], wp / wpm1 / wpm2 0-d, out [21, N]; the
// maps at HEALPix order `order`, the window from global pixel pix_base.
extern "C" int rayside_launch(const float* packed, const float* maps7,
                              const float* wp, const float* wpm1,
                              const float* wpm2, float* out, long long N,
                              long long W, long long pix_base, int order,
                              int born, void* stream) {
  if (N <= 0) return 0;
  const i64 nside = 1LL << order;
  // torchhp._ring_geo_closed's half, float(sqrt(1 / 6) / nside) in double
  const float half = static_cast<float>(std::sqrt(1.0 / 6.0) /
                                        static_cast<double>(nside));
  const unsigned blocks = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (born)
    rayside_kernel<true><<<blocks, kThreads, 0, st>>>(
        packed, maps7, wp, wpm1, wpm2, out, N, W, pix_base, nside, half);
  else
    rayside_kernel<false><<<blocks, kThreads, 0, st>>>(
        packed, maps7, wp, wpm1, wpm2, out, N, W, pix_base, nside, half);
  return static_cast<int>(cudaGetLastError());
}
