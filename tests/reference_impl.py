"""Pure-NumPy oracle for the reference solver semantics.

A deliberately literal, loop-level reimplementation of the CUDA mega-kernel
(oct_variational_optical_flow.cu) used ONLY as a test oracle: the framework's
vectorized JAX solver must reproduce these numbers.  Slow -- use tiny images.
"""

from __future__ import annotations

import math

import numpy as np

F = np.float32


def bc(x, n):
    return min(max(int(x), 0), n - 1)


def bc_f(x, n):
    """oct_bc_cu on floats: clamp to [0, n-1], flag if clamped."""
    flag = False
    if x < 0:
        x = 0.0
        flag = True
    if x >= n:
        x = float(n - 1)
        flag = True
    return x, flag


def psi(x):
    return 1.0 / math.sqrt(x + 1e-6)


def cell(v, x):
    return v[1] + 0.5 * x * (v[2] - v[0] + x * (2.0 * v[0] - 5.0 * v[1] + 4.0 * v[2] - v[3]
                                                + x * (3.0 * (v[1] - v[2]) + v[3] - v[0])))


def bicubic(img, uu, vv):
    """oct_bicubic_cu: truncated+clamped taps, fraction from clamped base."""
    h, w = img.shape
    xs = [bc(int(uu + o), w) for o in (-1, 0, 1, 2)]
    ys = [bc(int(vv + o), h) for o in (-1, 0, 1, 2)]
    cols = []
    for cx in xs:
        taps = [img[yy, cx] for yy in ys]
        cols.append(cell(taps, vv - ys[1]))
    return cell(cols, uu - xs[1])


def compgrad(img):
    """4th-order gradients with clamped taps (oct_compgrad_cu)."""
    h, w = img.shape
    gx = np.zeros_like(img)
    gy = np.zeros_like(img)
    for j in range(h):
        for i in range(w):
            ip1, ip2 = bc(i + 1, w), bc(i + 2, w)
            im1, im2 = bc(i - 1, w), bc(i - 2, w)
            jp1, jp2 = bc(j + 1, h), bc(j + 2, h)
            jm1, jm2 = bc(j - 1, h), bc(j - 2, h)
            gx[j, i] = (-img[j, ip2] + 8.0 * img[j, ip1] - 8.0 * img[j, im1] + img[j, im2]) / 12.0
            gy[j, i] = (-img[jp2, i] + 8.0 * img[jp1, i] - 8.0 * img[jm1, i] + img[jm2, i]) / 12.0
    return gx, gy


def gaussian_kernel(sigma, filtsize):
    s = 2.0 * sigma * sigma
    k = np.array([math.exp(-(x * x) / s) / (math.pi * s)
                  for x in range(-filtsize, filtsize + 1)])
    return k / k.sum()


def blur(img, kern, filtsize):
    """convh+convv: clamp BC, taps [-filtsize, filtsize)."""
    h, w = img.shape
    tmp = np.zeros_like(img)
    out = np.zeros_like(img)
    for j in range(h):
        for i in range(w):
            tmp[j, i] = sum(kern[k + filtsize] * img[j, bc(i + k, w)]
                            for k in range(-filtsize, filtsize))
    for j in range(h):
        for i in range(w):
            out[j, i] = sum(kern[k + filtsize] * tmp[bc(j + k, h), i]
                            for k in range(-filtsize, filtsize))
    return out


def zoom_size(n, factor):
    return int(n * factor + 0.5)


def solver_downsample(img, factor):
    """Blur at full res + integer-position 'bicubic' (= floor subsample)."""
    h, w = img.shape
    nxx, nyy = zoom_size(w, factor), zoom_size(h, factor)
    sigma_sz = 1.0 / math.sqrt(2.0 * factor)
    filtsize = max(int(2.0 * sigma_sz), 5)
    sigma_w = 0.6 * math.sqrt(1.0 / (factor * factor) - 1.0)
    kern = gaussian_kernel(sigma_w, filtsize)
    b = blur(img, kern, filtsize)
    out = np.zeros((nyy, nxx), img.dtype)
    for jj in range(nyy):
        for ii in range(nxx):
            i2 = int(np.float32(ii) / np.float32(factor))
            j2 = int(np.float32(jj) / np.float32(factor))
            out[jj, ii] = b[min(j2, h - 1), min(i2, w - 1)]
    return out


def zoom_in_flow(flow, nxx, nyy, sf):
    h, w = flow.shape
    fx = np.float32(nxx) / np.float32(w)
    fy = np.float32(nyy) / np.float32(h)
    out = np.zeros((nyy, nxx), flow.dtype)
    for jj in range(nyy):
        for ii in range(nxx):
            i2 = (np.float32(ii) / fx) - (np.float32(0.5) - np.float32(0.5) / fx)
            j2 = (np.float32(jj) / fy) - (np.float32(0.5) - np.float32(0.5) / fy)
            out[jj, ii] = bicubic(flow, i2, j2) / sf
    return out


def assemble(geo1, geo2, grads, u, v, uhat, vhat, al1, alpha, lam_a, lambdac, dozim):
    """Direct translation of the assembly loop (ref :611-1097).

    geo1/geo2: (C,H,W); grads: dict of gx1,gy1,gx2,gy2,gxx,gxy,gyy (C,H,W).
    Returns coefficient arrays + rhs (a1,a2,a4,a5,a6,a7,a8,bu,bv).
    """
    c_, h, w = geo1.shape
    A = {k: np.zeros((h, w), F) for k in
         ("a1", "a2", "a4", "a5", "a6", "a7", "a8", "bu", "bv")}
    for j in range(h):
        for i in range(w):
            # mirror-at-1 neighbour indices
            iW = i - 1 + (2 if i == 0 else 0)
            iE = i + 1 - (2 if i == w - 1 else 0)
            jN = j - 1 + (2 if j == 0 else 0)
            jS = j + 1 - (2 if j == h - 1 else 0)
            up0p0 = u[j, i]; vp0p0 = v[j, i]
            up1p0 = u[j, iE]; um1p0 = u[j, iW]
            up0p1 = u[jS, i]; up0m1 = u[jN, i]
            up1p1 = u[jS, iE]; up1m1 = u[jN, iE]
            um1p1 = u[jS, iW]; um1m1 = u[jN, iW]
            vp1p0 = v[j, iE]; vm1p0 = v[j, iW]
            vp0p1 = v[jS, i]; vp0m1 = v[jN, i]
            vp1p1 = v[jS, iE]; vp1m1 = v[jN, iE]
            vm1p1 = v[jS, iW]; vm1m1 = v[jN, iW]

            sq = lambda x: x * x
            Uip1 = sq(up1p0 - up0p0) + sq(0.25 * ((up1p1 - up1m1) + (up0p1 - up0m1))) \
                + sq(vp1p0 - vp0p0) + sq(0.25 * ((vp1p1 - vp1m1) + (vp0p1 - vp0m1)))
            Uim1 = sq(up0p0 - um1p0) + sq(0.25 * ((um1p1 - um1m1) + (up0p1 - up0m1))) \
                + sq(vp0p0 - vm1p0) + sq(0.25 * ((vm1p1 - vm1m1) + (vp0p1 - vp0m1)))
            Ujp1 = sq(up0p1 - up0p0) + sq(0.25 * ((up1p1 - um1p1) + (up1p0 - um1p0))) \
                + sq(vp0p1 - vp0p0) + sq(0.25 * ((vp1p1 - vm1p1) + (vp1p0 - vm1p0)))
            Ujm1 = sq(up0p0 - up0m1) + sq(0.25 * ((up1m1 - um1m1) + (up1p0 - um1p0))) \
                + sq(vp0p0 - vp0m1) + sq(0.25 * ((vp1m1 - vm1m1) + (vp1p0 - vm1p0)))
            psis1, psis2, psis3, psis4 = psi(Uim1), psi(Ujm1), psi(Uip1), psi(Ujp1)
            psistot = psis1 + psis2 + psis3 + psis4
            psisnmiu = psis1 * um1p0 + psis2 * up0m1 + psis3 * up1p0 + psis4 * up0p1
            psisnmiv = psis1 * vm1p0 + psis2 * vp0m1 + psis3 * vp1p0 + psis4 * vp0p1
            psisnmiuq = um1p0 + up0m1 + up1p0 + up0p1
            psisnmivq = vm1p0 + vp0m1 + vp1p0 + vp0p1

            iv, bc2 = bc_f(i + up0p0, w)
            jv, bc3 = bc_f(j + vp0p0, h)
            iv1 = min(int(iv), w - 2)
            jv1 = min(int(jv), h - 2)
            p1 = (iv1 + 1) - iv
            p2 = iv - iv1
            p3 = (jv1 + 1) - jv
            p4 = jv - jv1

            vr1 = vr2 = vr4 = vr5 = vr6 = intc = 0.0
            vr12 = vr22 = vr42 = vr52 = vr62 = intc2 = 0.0
            for c in range(c_):
                def samp(a):
                    return p3 * (p1 * a[c, jv1, iv1] + p2 * a[c, jv1, iv1 + 1]) \
                        + p4 * (p1 * a[c, jv1 + 1, iv1] + p2 * a[c, jv1 + 1, iv1 + 1])
                g2 = samp(geo2)
                Ix = samp(grads["gx2"]); Iy = samp(grads["gy2"])
                Ixx = samp(grads["gxx"]); Ixy = samp(grads["gxy"]); Iyy = samp(grads["gyy"])
                if bc2:
                    Ix = Ixx = 0.0
                    Ixy = 0.0
                if bc3:
                    Iy = Iyy = 0.0
                    Ixy = 0.0
                It = g2 - geo1[c, j, i]
                Ixt = Ix - grads["gx1"][c, j, i]
                Iyt = Iy - grads["gy1"][c, j, i]
                if dozim:
                    na = 1.0 / (Ix * Ix + Iy * Iy + 1.0)
                    nb = 1.0 / (Ixx * Ixx + Ixy * Ixy + 1.0)
                    nc = 1.0 / (Ixy * Ixy + Iyy * Iyy + 1.0)
                else:
                    na = nb = nc = 1.0
                intc += na * It * It
                intc2 += nb * Ixt * Ixt + nc * Iyt * Iyt
                vr1 += na * Ix * Ix
                vr12 += nb * Ixx * Ixx + nc * Ixy * Ixy
                vr2 += na * Ix * Iy
                vr22 += nb * Ixx * Ixy + nc * Iyy * Ixy
                vr4 += na * Iy * Iy
                vr42 += nb * Ixy * Ixy + nc * Iyy * Iyy
                vr5 += -na * It * Ix
                vr52 += -(nb * Ixt * Ixx + nc * Iyt * Ixy)
                vr6 += -na * It * Iy
                vr62 += -(nb * Ixt * Ixy + nc * Iyt * Iyy)

            psid = psi(intc) / alpha
            psid2 = lam_a * psi(intc2)
            oma = 1.0 - al1
            A["a1"][j, i] = al1 * (vr1 / alpha + lam_a * vr12 + lambdac + 4.0) \
                + oma * (psid * vr1 + psid2 * vr12 + lambdac + psistot)
            A["a2"][j, i] = al1 * (vr2 / alpha + lam_a * vr22) + oma * (psid * vr2 + psid2 * vr22)
            A["a4"][j, i] = al1 * (vr4 / alpha + lam_a * vr42 + lambdac + 4.0) \
                + oma * (psid * vr4 + psid2 * vr42 + lambdac + psistot)
            A["a5"][j, i] = -(al1 + oma * psis1)
            A["a6"][j, i] = -(al1 + oma * psis2)
            A["a7"][j, i] = -(al1 + oma * psis3)
            A["a8"][j, i] = -(al1 + oma * psis4)
            hu = lambdac * (up0p0 - uhat[j, i])
            hv = lambdac * (vp0p0 - vhat[j, i])
            A["bu"][j, i] = al1 * (vr5 / alpha + lam_a * vr52 - hu + psisnmiuq - 4.0 * up0p0) \
                + oma * (psid * vr5 + psid2 * vr52 - hu + psisnmiu - psistot * up0p0)
            A["bv"][j, i] = al1 * (vr6 / alpha + lam_a * vr62 - hv + psisnmivq - 4.0 * vp0p0) \
                + oma * (psid * vr6 + psid2 * vr62 - hv + psisnmiv - psistot * vp0p0)
    return A


def dense_matrix(A):
    """Dense 2N x 2N system from the coefficient arrays, with the CSR fill's
    edge folding (ref :929-1077)."""
    h, w = A["a1"].shape
    n2 = 2 * h * w
    M = np.zeros((n2, n2), F)
    for j in range(h):
        for i in range(w):
            r = 2 * (j * w + i)
            iW = i - 1 + (2 if i == 0 else 0)
            iE = i + 1 - (2 if i == w - 1 else 0)
            jN = j - 1 + (2 if j == 0 else 0)
            jS = j + 1 - (2 if j == h - 1 else 0)
            for rr, diag in ((r, A["a1"][j, i]), (r + 1, A["a4"][j, i])):
                M[rr, rr] += diag
                M[rr, r + 1 if rr == r else r] += A["a2"][j, i]
                off = rr - r
                M[rr, 2 * (j * w + iW) + off] += A["a5"][j, i]
                M[rr, 2 * (j * w + iE) + off] += A["a7"][j, i]
                M[rr, 2 * (jN * w + i) + off] += A["a6"][j, i]
                M[rr, 2 * (jS * w + i) + off] += A["a8"][j, i]
    return M


def pcg(M, diag, b, tol, iters):
    """Reference PCG (ref :1100-1183) in float32."""
    x = np.zeros_like(b)
    r = b.copy()
    z = r / diag
    p = z.copy()
    resid = F(r @ r)
    rz = F(r @ z)
    k = 0
    while resid > tol and k < iters:
        ap = (M @ p).astype(F)
        alpha = rz / F(p @ ap)
        x = x + alpha * p
        r = r - alpha * ap
        resid = F(r @ r)
        z = r / diag
        rz_new = F(r @ z)
        beta = rz_new / rz
        rz = rz_new
        p = z + beta * p
        k += 1
    return x


def solve_level(geo1, geo2, u, v, uhat, vhat, alpha, lam, lambdac,
                liters, cgiters, tol, dozim, gnc_steps=3):
    """One pyramid level: GNC x liters of assemble + PCG."""
    grads = {}
    grads["gx1"] = np.stack([compgrad(c)[0] for c in geo1])
    grads["gy1"] = np.stack([compgrad(c)[1] for c in geo1])
    grads["gx2"] = np.stack([compgrad(c)[0] for c in geo2])
    grads["gy2"] = np.stack([compgrad(c)[1] for c in geo2])
    grads["gxx"] = np.stack([compgrad(c)[0] for c in grads["gx2"]])
    grads["gxy"] = np.stack([compgrad(c)[0] for c in grads["gy2"]])
    grads["gyy"] = np.stack([compgrad(c)[1] for c in grads["gy2"]])
    h, w = u.shape
    lam_a = lam / alpha
    for gnc in range(gnc_steps):
        al1 = 1.0 - 0.5 * gnc
        for _ in range(liters):
            A = assemble(geo1, geo2, grads, u, v, uhat, vhat,
                         al1, alpha, lam_a, lambdac, dozim)
            M = dense_matrix(A)
            diag = np.empty(2 * h * w, F)
            diag[0::2] = A["a1"].reshape(-1)
            diag[1::2] = A["a4"].reshape(-1)
            b = np.empty(2 * h * w, F)
            b[0::2] = A["bu"].reshape(-1)
            b[1::2] = A["bv"].reshape(-1)
            x = pcg(M, diag, b, tol, cgiters)
            u = u + x[0::2].reshape(h, w)
            v = v + x[1::2].reshape(h, w)
    return u, v


def variational_flow(geo1, geo2, u0, v0, alpha=5.0, lam=1.0, lambdac=0.0,
                     scale_factor=0.5, kiters=4, liters=3, cgiters=30,
                     tol=1e-8, dozim=True):
    """Full coarse-to-fine oracle (ref :487-1210)."""
    if geo1.ndim == 2:
        geo1 = geo1[None]
        geo2 = geo2[None]
    h, w = u0.shape
    u = v = None
    for k in range(kiters):
        factor = float(np.float32(scale_factor) ** (kiters - k - 1))
        nxx, nyy = zoom_size(w, factor), zoom_size(h, factor)
        lc = (lambdac / alpha) * (0.5 ** k)
        if k == kiters - 1:
            g1, g2 = geo1, geo2
            uhat, vhat = u0.copy(), v0.copy()
        else:
            g1 = np.stack([solver_downsample(c, factor) for c in geo1])
            g2 = np.stack([solver_downsample(c, factor) for c in geo2])
            uhat = solver_downsample(u0, factor) * F(factor)
            vhat = solver_downsample(v0, factor) * F(factor)
        if k == 0:
            u, v = uhat.copy(), vhat.copy()
        else:
            u = zoom_in_flow(u, nxx, nyy, F(scale_factor))
            v = zoom_in_flow(v, nxx, nyy, F(scale_factor))
        u, v = solve_level(g1, g2, u, v, uhat, vhat, alpha, lam, lc,
                           liters, cgiters, tol, dozim)
    return u, v


# ---------------------------------------------------------------------------
# patch-match oracle (oct_patch_match_optical_flow.cc)
# ---------------------------------------------------------------------------

def jsose(geo1, geo2, i, j, n, m, rad):
    h, w = geo1.shape
    s = 0.0
    for k in range(2 * rad + 1):
        for l in range(2 * rad + 1):
            ic1 = bc(i + k - rad, w)
            jc1 = bc(j + l - rad, h)
            ic2 = bc(i + k + n - rad, w)
            jc2 = bc(j + l + m - rad, h)
            d = geo2[jc2, ic2] - geo1[jc1, ic1]
            s += d * d
    return s


def jquad_interp(y2, y1, y3, x2, x1, x3):
    c1 = (y2 - y1) / (x2 - x1)
    c2 = (x2 * x2 - x1 * x1) / (x2 - x1)
    a = (y3 - c1 * x3 - y1 + c1 * x1) / (x3 * x3 - c2 * x3 - x1 * x1 + c2 * x1)
    b = c1 - a * c2
    if a == 0:
        return x2
    return -b / (2.0 * a)


def patch_match(geo1, geo2, u0, v0, rad=2, srad=2):
    h, w = geo1.shape
    sx = 2 * srad + 1
    uo = np.zeros((h, w), F)
    vo = np.zeros((h, w), F)
    for j in range(h):
        for i in range(w):
            ibc = bc(int(i + u0[j, i]), w)
            jbc = bc(int(j + v0[j, i]), h)
            n = m = 0
            dn, dm = 0, -1
            summin = None
            for _ in range(sx * sx):
                sumv = jsose(geo1, geo2, ibc, jbc, n, m, rad)
                if summin is None or sumv < summin:
                    summin, nmin, mmin = sumv, n, m
                if (n == m) or (n < 0 and n == -m) or (n > 0 and n == 1 - m):
                    dn, dm = -dm, dn
                n += dn
                m += dm
            s1 = jsose(geo1, geo2, ibc, jbc, nmin + 1, mmin, rad)
            s2 = jsose(geo1, geo2, ibc, jbc, nmin - 1, mmin, rad)
            if summin < s1 and summin < s2:
                uo[j, i] = jquad_interp(summin, s1, s2, i + nmin, i + nmin + 1,
                                        i + nmin - 1) - i
            else:
                uo[j, i] = nmin
            s1 = jsose(geo1, geo2, ibc, jbc, nmin, mmin + 1, rad)
            s2 = jsose(geo1, geo2, ibc, jbc, nmin, mmin - 1, rad)
            if summin < s1 and summin < s2:
                vo[j, i] = jquad_interp(summin, s1, s2, j + mmin, j + mmin + 1,
                                        j + mmin - 1) - j
            else:
                vo[j, i] = mmin
    return uo, vo


# ---------------------------------------------------------------------------
# srsal oracle (oct_srsal_cuda.cu)
# ---------------------------------------------------------------------------

def bc_reflect(x, n):
    """oct_bc_cuda: x<0 -> -x (reflect), x>=n -> 2n-x-1 (symmetric)."""
    if x < 0:
        x = -x
    if x >= n:
        x = n - (x - n + 1)
    return x


def srsal(u, v, cth, filtsigma=9.0, sigpix=20.0):
    filtsize = int(2 * filtsigma)
    gk = gaussian_kernel(filtsigma, filtsize)
    sigpix2 = -1.0 / (2.0 * sigpix * sigpix)
    h, w = u.shape
    uo = np.zeros_like(u)
    vo = np.zeros_like(v)
    for j in range(h):
        for i in range(w):
            au = av = a2 = 0.0
            for kc in range(2 * filtsize + 1):
                for lc in range(2 * filtsize + 1):
                    ivc = bc_reflect(i + kc - filtsize, w)
                    jvc = bc_reflect(j + lc - filtsize, h)
                    pixm = cth[jvc, ivc] - cth[j, i]
                    a1 = gk[kc] * gk[lc] * math.exp(pixm * pixm * sigpix2)
                    a2 += a1
                    au += u[jvc, ivc] * a1
                    av += v[jvc, ivc] * a1
            uo[j, i] = au / a2
            vo[j, i] = av / a2
    return uo, vo


# ---------------------------------------------------------------------------
# forward-splat oracle (oct_warpflow, oct_interp.cc:17-63)
# ---------------------------------------------------------------------------

def warpflow(u, v, im1, im2, time):
    h, w = u.shape
    ut = np.full((h, w), -999.0, F)
    vt = np.full((h, w), -999.0, F)
    sos = np.full((h, w), 999999.0, F)

    def clamp(x, n):
        return min(max(int(round(x)), 0), n - 2)

    for j in range(h):
        for i in range(w):
            iv = clamp(i + time * u[j, i], w)
            jv = clamp(j + time * v[j, i], h)
            iv2 = clamp(i + u[j, i], w)
            jv2 = clamp(j + v[j, i], h)
            for l in range(2):
                for k in range(2):
                    t_j, t_i = jv + l, iv + k
                    d = im1[j, i] - im2[jv2 + l, iv2 + k]
                    d2 = d * d
                    if ut[t_j, t_i] < -998 or sos[t_j, t_i] > d2:
                        ut[t_j, t_i] = u[j, i]
                        vt[t_j, t_i] = v[j, i]
                        sos[t_j, t_i] = d2
    return ut, vt


def apply_stencil_np(A, du, dv):
    """Matrix-free A @ (du, dv): exactly dense_matrix's row structure
    (same coefficients, same edge-folded mirror indices iW=1 at i=0 etc.,
    ref :929-1077) without materializing the 2N x 2N matrix, so the oracle
    scales to the 256^2 golden fixture (the dense form is 64 GB there).
    Equivalence to dense_matrix checked by tests/test_golden.py on a small
    grid.  float32 ops; summation order differs from BLAS np.dot exactly
    as the dense path's own reassociation does -- the oracle contract is
    EPE-level, not bitwise."""
    h, w = du.shape
    iW = np.arange(w) - 1
    iW[0] = 1
    iE = np.arange(w) + 1
    iE[-1] = w - 2
    jN = np.arange(h) - 1
    jN[0] = 1
    jS = np.arange(h) + 1
    jS[-1] = h - 2

    def op(f):
        return (A["a5"] * f[:, iW] + A["a7"] * f[:, iE]
                + A["a6"] * f[jN, :] + A["a8"] * f[jS, :]).astype(F)

    au = (A["a1"] * du + A["a2"] * dv).astype(F) + op(du)
    av = (A["a2"] * du + A["a4"] * dv).astype(F) + op(dv)
    return au.astype(F), av.astype(F)


def pcg_matfree(A, b_u, b_v, tol, iters):
    """Reference PCG (ref :1100-1183) on the matrix-free operator."""
    h, w = A["a1"].shape
    xu = np.zeros((h, w), F)
    xv = np.zeros((h, w), F)
    ru, rv = b_u.copy(), b_v.copy()
    zu = (ru / A["a1"]).astype(F)
    zv = (rv / A["a4"]).astype(F)
    pu, pv = zu.copy(), zv.copy()
    resid = F(np.vdot(ru, ru) + np.vdot(rv, rv))
    rz = F(np.vdot(ru, zu) + np.vdot(rv, zv))
    k = 0
    while resid > tol and k < iters:
        apu, apv = apply_stencil_np(A, pu, pv)
        alpha = rz / F(np.vdot(pu, apu) + np.vdot(pv, apv))
        xu = (xu + alpha * pu).astype(F)
        xv = (xv + alpha * pv).astype(F)
        ru = (ru - alpha * apu).astype(F)
        rv = (rv - alpha * apv).astype(F)
        resid = F(np.vdot(ru, ru) + np.vdot(rv, rv))
        zu = (ru / A["a1"]).astype(F)
        zv = (rv / A["a4"]).astype(F)
        rz_new = F(np.vdot(ru, zu) + np.vdot(rv, zv))
        beta = rz_new / rz
        rz = rz_new
        pu = (zu + beta * pu).astype(F)
        pv = (zv + beta * pv).astype(F)
        k += 1
    return xu, xv


def solve_level_matfree(geo1, geo2, u, v, uhat, vhat, alpha, lam, lambdac,
                        liters, cgiters, tol, dozim, gnc_steps=3):
    """solve_level with the matrix-free PCG (identical math/stopping)."""
    grads = {}
    grads["gx1"] = np.stack([compgrad(c)[0] for c in geo1])
    grads["gy1"] = np.stack([compgrad(c)[1] for c in geo1])
    grads["gx2"] = np.stack([compgrad(c)[0] for c in geo2])
    grads["gy2"] = np.stack([compgrad(c)[1] for c in geo2])
    grads["gxx"] = np.stack([compgrad(c)[0] for c in grads["gx2"]])
    grads["gxy"] = np.stack([compgrad(c)[0] for c in grads["gy2"]])
    grads["gyy"] = np.stack([compgrad(c)[1] for c in grads["gy2"]])
    lam_a = lam / alpha
    for gnc in range(gnc_steps):
        al1 = 1.0 - 0.5 * gnc
        for _ in range(liters):
            A = assemble(geo1, geo2, grads, u, v, uhat, vhat,
                         al1, alpha, lam_a, lambdac, dozim)
            du, dv = pcg_matfree(A, A["bu"], A["bv"], tol, cgiters)
            u = (u + du).astype(F)
            v = (v + dv).astype(F)
    return u, v


def variational_flow_matfree(geo1, geo2, u0, v0, alpha=5.0, lam=1.0,
                             lambdac=0.0, scale_factor=0.5, kiters=4,
                             liters=3, cgiters=30, tol=1e-8, dozim=True):
    """variational_flow with the matrix-free level solver (for fixture
    sizes where the dense matrix is infeasible)."""
    if geo1.ndim == 2:
        geo1 = geo1[None]
        geo2 = geo2[None]
    u = v = None
    for k in range(kiters):
        factor = float(np.float32(scale_factor) ** (kiters - k - 1))
        nxx, nyy = zoom_size(geo1.shape[-1], factor), \
            zoom_size(geo1.shape[-2], factor)
        lc = (lambdac / alpha) * (0.5 ** k)
        if k == kiters - 1:
            g1, g2 = geo1, geo2
            uhat, vhat = u0.copy(), v0.copy()
        else:
            g1 = np.stack([solver_downsample(c, factor) for c in geo1])
            g2 = np.stack([solver_downsample(c, factor) for c in geo2])
            uhat = solver_downsample(u0, factor) * F(factor)
            vhat = solver_downsample(v0, factor) * F(factor)
        if k == 0:
            u, v = uhat.copy(), vhat.copy()
        else:
            u = zoom_in_flow(u, nxx, nyy, F(scale_factor))
            v = zoom_in_flow(v, nxx, nyy, F(scale_factor))
        u, v = solve_level_matfree(g1, g2, u, v, uhat, vhat, alpha, lam, lc,
                                   liters, cgiters, tol, dozim)
    return u, v


def sor_redblack(A, tol, iters, omega=1.9):
    """Loop-level red-black SOR on the matrix-free operator, the relaxer
    flow.cg.sor_solve implements.  From x = 0, each iteration visits the
    red pixels ((i + j) even), then the black ones, and replaces each
    pixel's (u, v) by the over-relaxed exact solution of its 2x2 block
    (a1 a2; a2 a4) for the current residual.  A red pixel's neighbours are
    all black, so visiting one colour in raster order equals updating it
    at once.  The stopping test reads the full-grid ||b - A x||^2 that the
    previous iteration's red half-sweep saw (its incoming iterate; ||b||^2
    before the first), or stops after ``iters`` iterations.

    Returns (du, dv, iterations run)."""
    h, w = A["a1"].shape
    xu = np.zeros((h, w), F)
    xv = np.zeros((h, w), F)
    resid = F(np.vdot(A["bu"], A["bu"]) + np.vdot(A["bv"], A["bv"]))
    om = F(omega)
    k = 0
    while resid > tol and k < iters:
        au, av = apply_stencil_np(A, xu, xv)
        ru = (A["bu"] - au).astype(F)
        rv = (A["bv"] - av).astype(F)
        resid = F(np.vdot(ru, ru) + np.vdot(rv, rv))
        for colour in (0, 1):
            for j in range(h):
                jN = j - 1 if j > 0 else 1
                jS = j + 1 if j < h - 1 else h - 2
                for i in range((j + colour) % 2, w, 2):
                    iW = i - 1 if i > 0 else 1
                    iE = i + 1 if i < w - 1 else w - 2
                    a1, a2, a4 = A["a1"][j, i], A["a2"][j, i], A["a4"][j, i]
                    a5, a6, a7, a8 = (A["a5"][j, i], A["a6"][j, i],
                                      A["a7"][j, i], A["a8"][j, i])
                    nu = (a5 * xu[j, iW] + a7 * xu[j, iE]
                          + a6 * xu[jN, i] + a8 * xu[jS, i])
                    nv = (a5 * xv[j, iW] + a7 * xv[j, iE]
                          + a6 * xv[jN, i] + a8 * xv[jS, i])
                    r_u = A["bu"][j, i] - (a1 * xu[j, i] + a2 * xv[j, i] + nu)
                    r_v = A["bv"][j, i] - (a2 * xu[j, i] + a4 * xv[j, i] + nv)
                    rdet = F(1.0) / (a1 * a4 - a2 * a2)
                    xu[j, i] += om * ((a4 * r_u - a2 * r_v) * rdet)
                    xv[j, i] += om * ((a1 * r_v - a2 * r_u) * rdet)
        k += 1
    return xu, xv, k


def warp_bilinear(fields, u, v):
    """Bilinear samples of a (K, H, W) stack at (i + u, j + v) with the
    solver's position clamps (ref :727-758, the sampling inside the
    assembly loop above).  Returns (samples, bc_x, bc_y)."""
    k_, h, w = fields.shape
    out = np.zeros((k_, h, w), F)
    bcx = np.zeros((h, w), bool)
    bcy = np.zeros((h, w), bool)
    for j in range(h):
        for i in range(w):
            iv, bcx[j, i] = bc_f(F(i) + u[j, i], w)
            jv, bcy[j, i] = bc_f(F(j) + v[j, i], h)
            iv1 = min(int(iv), w - 2)
            jv1 = min(int(jv), h - 2)
            p1 = F(iv1 + 1) - F(iv)
            p2 = F(iv) - F(iv1)
            p3 = F(jv1 + 1) - F(jv)
            p4 = F(jv) - F(jv1)
            for c in range(k_):
                a = fields[c]
                out[c, j, i] = p3 * (p1 * a[jv1, iv1] + p2 * a[jv1, iv1 + 1]) \
                    + p4 * (p1 * a[jv1 + 1, iv1] + p2 * a[jv1 + 1, iv1 + 1])
    return out, bcx, bcy
