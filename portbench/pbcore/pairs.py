"""Seeded synthetic image pairs: frozen copies of `textured_image`,
`true_homography`, `warp_image`, `warp_pair`, `tilted_pair`,
`two_plane_pair` (the images and F; not its grid) and `corner_error` from
mods_tpu_torch/testing.py, so that later edits to the program leave the
benchmark's inputs as they are."""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def textured_image(h: int, w: int, seed: int) -> np.ndarray:
    """[h, w] float32 image in 0..255: noise blurred at sigmas 1..16."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float64)
    for sigma in (1.0, 2.0, 4.0, 8.0, 16.0):
        band = ndimage.gaussian_filter(rng.standard_normal((h, w)), sigma,
                                       mode="reflect")
        img += band / (band.std() + 1e-12)
    img -= img.min()
    return (255.0 * img / img.max()).astype(np.float32)


def true_homography(h: int, w: int) -> np.ndarray:
    """A mild perspective warp of an [h, w] image: rotation by ~4 degrees,
    scale 0.92, a shift and a small perspective term."""
    c, s = np.cos(0.07), np.sin(0.07)
    S = np.array([[0.92 * c, -0.92 * s, 0.0], [0.92 * s, 0.92 * c, 0.0],
                  [0.0, 0.0, 1.0]])
    Tc = np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1.0]])
    P = np.array([[1, 0, 0], [0, 1, 0], [0.1 / w, 0.05 / h, 1.0]])
    Tb = np.array([[1, 0, w / 2 + 0.03 * w], [0, 1, h / 2 - 0.02 * h], [0, 0, 1.0]])
    H = Tb @ P @ S @ Tc
    return H / H[2, 2]


def warp_image(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """img2(x) = img(H^-1 x), bilinear, zero outside."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.linalg.inv(H) @ np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    sx, sy = pts[0] / pts[2], pts[1] / pts[2]
    out = ndimage.map_coordinates(img.astype(np.float64), [sy, sx], order=1,
                                  mode="constant", cval=0.0)
    return out.reshape(h, w).astype(np.float32)


def warp_pair(h: int, w: int, seed: int):
    """(img1, img2, H) with img2 = img1 warped by the known H."""
    img1 = textured_image(h, w, seed)
    H = true_homography(h, w)
    return img1, warp_image(img1, H), H


def tilted_pair(h: int, w: int, seed: int, tilt: float, psi: float):
    """(img1, img2, H): img2 = img1 warped by "rotate by psi, compress the x
    axis by `tilt`, rotate back, shift" (a wide-baseline view of a plane),
    H that map as 3x3; the image centre stays at the canvas centre."""
    img1 = textured_image(h, w, seed)
    c, s = np.cos(psi), np.sin(psi)
    R = np.array([[c, -s], [s, c]])
    M = R @ np.diag([1.0 / tilt, 1.0]) @ R.T
    ctr = np.array([w / 2.0, h / 2.0])
    H = np.eye(3)
    H[:2, :2] = M
    H[:2, 2] = ctr - M @ ctr + np.array([0.02 * w, -0.01 * h])
    return img1, warp_image(img1, H), H


def two_plane_pair(h: int, w: int, seed: int):
    """(img1, img2, F): a piecewise-planar scene seen by two cameras, with
    x2^T F x1 = 0 for every true correspondence (F unit norm).  Camera 1
    is K [I | 0] with f = 800 and the principal point at the image centre;
    camera 2 maps X to R X + t, R a yaw of -8 degrees, t = (0.25, 0.02,
    0.05).  img1 shows plane 0 ({n0.X = 4}) left of w/2 and plane 1
    ({n1.X = 8}) right of it, the normals 20 degrees apart; each maps img1
    to img2 by its induced homography, the nearer plane wins where both
    cover a pixel of img2, and pixels neither covers are 0.  A homography
    fits one plane, an F both (~25 px of parallax)."""
    img1 = textured_image(h, w, seed)
    f = 800.0
    K = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    Ki = np.linalg.inv(K)
    yaw = np.deg2rad(-8.0)
    R = np.array([[np.cos(yaw), 0.0, np.sin(yaw)], [0.0, 1.0, 0.0],
                  [-np.sin(yaw), 0.0, np.cos(yaw)]])
    t = np.array([0.25, 0.02, 0.05])
    tx = np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]])
    F = Ki.T @ tx @ R @ Ki
    F /= np.linalg.norm(F)
    normals = [np.array([np.sin(a), 0.0, np.cos(a)]) for a in np.deg2rad([-10.0, 10.0])]
    depths = (4.0, 8.0)
    H = np.stack([K @ (R + np.outer(t, n) / d) @ Ki for n, d in zip(normals, depths)])
    split = w / 2.0

    def pre_image(x2h, i):
        """img1 pixels [N, 2] of plane i under img2 pixels x2h [3, N], their
        camera-2 depth (inf where plane i does not show there)."""
        p = np.linalg.inv(H[i]) @ x2h
        x1 = (p[:2] / p[2]).T
        on = ((x1[:, 0] < split) if i == 0 else (x1[:, 0] >= split)) \
            & (x1[:, 0] >= 0) & (x1[:, 0] <= w - 1) & (x1[:, 1] >= 0) \
            & (x1[:, 1] <= h - 1) & (p[2] > 0)
        r = Ki @ np.r_[x1.T, np.ones((1, len(x1)))]
        z = (R @ (r * (depths[i] / (normals[i] @ r))) + t[:, None])[2]
        return x1, np.where(on & (z > 0), z, np.inf)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x2h = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    (x1a, za), (x1b, zb) = pre_image(x2h, 0), pre_image(x2h, 1)
    x1 = np.where((za <= zb)[:, None], x1a, x1b)
    seen = np.isfinite(np.minimum(za, zb))
    img2 = ndimage.map_coordinates(img1.astype(np.float64), [x1[:, 1], x1[:, 0]],
                                   order=1, mode="constant", cval=0.0)
    img2 = np.where(seen, img2, 0.0).reshape(h, w).astype(np.float32)
    return img1, img2, F


def corner_error(H_est, H_true, h: int, w: int) -> float:
    """Largest distance in px between the image corners mapped by the two
    homographies (inf where H_est is missing or not finite)."""
    if H_est is None or not np.all(np.isfinite(H_est)):
        return float("inf")
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
                 np.float64).T
    a = np.asarray(H_est, np.float64) @ c
    b = np.asarray(H_true, np.float64) @ c
    return float(np.max(np.linalg.norm(a[:2] / a[2] - b[:2] / b[2], axis=0)))


def pool_seeds(seed: int, n: int):
    """n pair seeds drawn from the run's seed (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), 0x5EED])
    return [int(s) for s in ss.generate_state(n, dtype=np.uint32)]


def sampled_index(seed: int, n: int) -> int:
    """The pool pair whose answer `correct` judges, drawn from the seed."""
    return int(np.random.default_rng([int(seed) % (1 << 63), 0xC0DE]).integers(n))
