"""Seeded synthetic image pairs: frozen copies of `textured_image`,
`true_homography`, `warp_image`, `warp_pair`, `tilted_pair` and
`corner_error` from mods_tpu_torch/testing.py, so that later edits to the
program leave the benchmark's inputs as they are."""
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
