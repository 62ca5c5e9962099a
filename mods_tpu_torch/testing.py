"""Seeded synthetic image pairs for the port's tests and chip_smoke.py.

`textured_image` sums band-limited noise over several scales, so that the
detector finds keypoints at every octave; `warp_pair` warps it by a known
homography, `tilted_pair` by a strong affine tilt; `rolled_pair` is the
textured-noise pair rolled by 3 px; `two_plane_pair` is a scene of two
planes at different depths seen by two cameras, with a known fundamental
matrix, and `epipolar_error` measures an F against its true
correspondences.  `mods_schedule` is the two-step MODS escalation that
the tests and chip_smoke.py run, `mods_all_detectors_schedule` the same
shape over every detector (MSER, then Hessian-Affine, DoG and
Harris-Affine) with `mods_detectors_config`, `deep_config` the
reference's deep (AffNet, OriNet, HardNet) configuration.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import ndimage

from .config import detector_step


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


def rolled_pair(h: int = 96, w: int = 128, seed: int = 7):
    """Uniform noise and its copy rolled by 3 px along x."""
    base = np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)
    return base, np.roll(base, 3, axis=1)


def corner_error(H_est: np.ndarray, H_true: np.ndarray, h: int, w: int) -> float:
    """Largest distance in px between the image corners mapped by the two
    homographies."""
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
                 np.float64).T
    a = np.asarray(H_est, np.float64) @ c
    b = np.asarray(H_true, np.float64) @ c
    return float(np.max(np.linalg.norm(a[:2] / a[2] - b[:2] / b[2], axis=0)))


def tilted_pair(h: int, w: int, seed: int, tilt: float, psi: float):
    """(img1, img2, H): img1 a textured image, img2 = img1 warped by the
    affine map "rotate by psi, compress the x axis by `tilt`, rotate back,
    shift" (a wide-baseline view of a plane), H that map as 3x3.  The map
    keeps the image centre at the centre of the same-size canvas."""
    img1 = textured_image(h, w, seed)
    c, s = np.cos(psi), np.sin(psi)
    R = np.array([[c, -s], [s, c]])
    M = R @ np.diag([1.0 / tilt, 1.0]) @ R.T
    ctr = np.array([w / 2.0, h / 2.0])
    H = np.eye(3)
    H[:2, :2] = M
    H[:2, 2] = ctr - M @ ctr + np.array([0.02 * w, -0.01 * h])
    return img1, warp_image(img1, H), H


def mods_schedule(descriptor: str = "RootSIFT"):
    """The two-step escalation that load_iters reads from this
    iters_MODS-style text, built in code (<D> the descriptor):

        [HessianAffine0] TiltSet=1 ScaleSet=1 Phi=360 Descriptors=<D>
                         FGINNThreshold=0.8
        [Matching0]      SeparateDetectors=HessianAffine
                         SeparateDescriptors=<D>
        [HessianAffine1] TiltSet=1,2,4 Phi=72, the rest as step 0
        [Matching1]      as step 0

    Step 1 synthesizes 15 new views (5 at tilt 2, 10 at tilt 4)."""
    return [detector_step(["HessianAffine"], [1.0], 360.0, descriptor),
            detector_step(["HessianAffine"], [1.0, 2.0, 4.0], 72.0, descriptor)]


def mods_detectors_config():
    """Config() with the DoG and Harris-Affine detectors typed: Config()'s
    `dog` and `harris` carry detector_type "Hessian", and only load_config
    sets "DoG" and "Harris" (from the [DoG] and [HarrisAffine] sections).

    Thresholds: every scale-space detector keeps PyramidParams' default,
    16/3, which is what load_config leaves a detector whose INI section
    sets none; the reference's INIs are not in the repository, so no other
    value has a source.  On textured_image(256, 320, 1) that gives 1239
    Hessian, 224 DoG and 659 Harris regions (Harris' responses are orders
    above the threshold, DoG's near it).  iiDoGMode stays off; MSER keeps
    MSERParams' defaults."""
    from .config import Config
    cfg = Config()
    cfg.dog.pyramid.detector_type = "DoG"
    cfg.harris.pyramid.detector_type = "Harris"
    return cfg


def iters_ini(steps, min_matches: int = 15) -> str:
    """The iters_*.ini text that config.load_iters reads back to `steps`
    (a schedule of detector_step's): how a schedule built in code reaches
    the command line."""
    csv = lambda vals: ",".join(f"{v:g}" if isinstance(v, float) else v for v in vals)
    lines = ["[Iterations]", f"Steps={len(steps)}", f"minMatches={min_matches}"]
    for i, st in enumerate(steps):
        for det, d in st.detectors.items():
            descs = d["descriptors"]
            lines += [f"[{det}{i}]", f"TiltSet={csv(d['tilt_set'])}",
                      f"ScaleSet={csv(d['scale_set'])}", f"Phi={d['phi']:g}",
                      f"initSigma={d['init_sigma']:g}", f"doBlur={int(d['do_blur'])}",
                      f"Descriptors={csv(descs)}",
                      f"FGINNThreshold={csv([d['fginn'][x] for x in descs])}",
                      f"DistanceThreshold={csv([d['dist'][x] for x in descs])}"]
        lines += [f"[Matching{i}]",
                  f"SeparateDetectors={csv(st.separate_detectors)}",
                  f"SeparateDescriptors={csv(st.separate_descriptors)}",
                  f"GroupDetectors={csv(st.group_detectors)}",
                  f"GroupDescriptors={csv(st.group_descriptors)}"]
    return "\n".join(lines) + "\n"


def mods_all_detectors_schedule(descriptor: str = "RootSIFT"):
    """The reference's iters_MODS shape, built in code (its INI is not in
    the repository): step 0 MSER on the identity view; step 1
    HessianAffine, DoG and HarrisAffine each at TiltSet 1,2,4, Phi 72,
    matched separately.  Every step at FGINN 0.8 with `descriptor`.  Run it
    with mods_detectors_config(), which types DoG and Harris."""
    return [detector_step(["MSER"], [1.0], 360.0, descriptor),
            detector_step(["HessianAffine", "DoG", "HarrisAffine"],
                          [1.0, 2.0, 4.0], 72.0, descriptor)]


def deep_config():
    """The reference's deep configuration (config_aff_ori_desc_zeromq.ini)
    built from Config(): AffNet in place of Baumberg, OriNet in place of
    the gradient orientation.  The classic and deep INIs differ only in
    these toggles and the descriptor, which a schedule names
    (`mods_schedule("ZMQ")`)."""
    from .config import Config
    cfg = Config()
    cfg.hessian.affine.useZMQ = True
    cfg.hessian.affine.doBaumberg = False
    cfg.domori.useZMQ = True
    return cfg


@dataclass
class PlaneGrid:
    """The true correspondences of a `two_plane_pair` and its planes.

    xy1, xy2: [N, 2] a grid of img1 points of both planes that img2 sees
    unoccluded, and their images; plane: [N] 0 or 1.  H: [2, 3, 3] each
    plane's homography img1 -> img2; img1 columns < split show plane 0,
    the others plane 1."""
    xy1: np.ndarray
    xy2: np.ndarray
    plane: np.ndarray
    H: np.ndarray
    split: float

    def plane_of(self, xy1, xy2, tol: float = 3.0) -> np.ndarray:
        """[N] the plane that each correspondence (xy1, xy2) is a true match
        of: xy1 on the plane's side of img1 and xy2 within tol px of the
        plane's homography; -1 for neither."""
        xy1 = np.asarray(xy1, np.float64)
        xy2 = np.asarray(xy2, np.float64)
        side = (xy1[:, 0] >= self.split).astype(int)
        p = np.einsum("nij,nj->ni", self.H[side], np.c_[xy1, np.ones(len(xy1))])
        ok = np.linalg.norm(p[:, :2] / p[:, 2:] - xy2, axis=1) <= tol
        return np.where(ok, side, -1)


def two_plane_pair(h: int, w: int, seed: int):
    """(img1, img2, F, grid): a piecewise-planar scene seen by two cameras,
    with x2^T F x1 = 0 for every true correspondence.

    Camera 1 is K [I | 0], K = [[f, 0, w/2], [0, f, h/2], [0, 0, 1]] with
    f = 800; camera 2 maps X to R X + t, R a yaw of -8 degrees about the
    y axis, t = (0.25, 0.02, 0.05).  img1 (`textured_image(h, w, seed)`)
    shows plane 0, {X : n0.X = 4}, in its columns left of w/2 and plane 1,
    {X : n1.X = 8}, right of it; the normals lie in the x-z plane at -10
    and +10 degrees from the optical axis (20 degrees apart).  Each plane
    maps img1 to img2 by its induced homography Hi = K (R + t ni^T / di)
    K^-1; where both planes cover a pixel of img2 the nearer one (in
    camera 2) wins, and pixels neither covers are 0.  F = K^-T [t]x R K^-1
    holds for both planes, so a homography fits one of them and an F both
    (their parallax is ~25 px at f = 800).  `grid` (PlaneGrid) holds
    every 16th pixel of each plane that img2 sees unoccluded."""
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

    def depth2(x1h, i):
        """Camera-2 depth of the plane-i points seen at img1 pixels x1h [3, N]."""
        r = Ki @ x1h
        X = r * (depths[i] / (normals[i] @ r))
        return (R @ X + t[:, None])[2]

    def pre_image(x2h, i):
        """img1 pixels [N, 2] of plane i under img2 pixels x2h [3, N], their
        camera-2 depth (inf where plane i does not show there)."""
        p = np.linalg.inv(H[i]) @ x2h
        x1 = (p[:2] / p[2]).T
        on = ((x1[:, 0] < split) if i == 0 else (x1[:, 0] >= split)) \
            & (x1[:, 0] >= 0) & (x1[:, 0] <= w - 1) & (x1[:, 1] >= 0) \
            & (x1[:, 1] <= h - 1) & (p[2] > 0)
        z = depth2(np.r_[x1.T, np.ones((1, len(x1)))], i)
        return x1, np.where(on & (z > 0), z, np.inf)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x2h = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    (x1a, za), (x1b, zb) = pre_image(x2h, 0), pre_image(x2h, 1)
    x1 = np.where((za <= zb)[:, None], x1a, x1b)
    seen = np.isfinite(np.minimum(za, zb))
    img2 = ndimage.map_coordinates(img1.astype(np.float64), [x1[:, 1], x1[:, 0]],
                                   order=1, mode="constant", cval=0.0)
    img2 = np.where(seen, img2, 0.0).reshape(h, w).astype(np.float32)

    # the grid: every 16th img1 pixel, kept where img2 sees its own plane
    gy, gx = np.mgrid[8:h - 8:16, 8:w - 8:16].astype(np.float64)
    g1 = np.stack([gx.ravel(), gy.ravel()], 1)
    plane = (g1[:, 0] >= split).astype(int)
    p = np.einsum("nij,nj->ni", H[plane], np.c_[g1, np.ones(len(g1))])
    g2 = p[:, :2] / p[:, 2:]
    inside = (g2[:, 0] >= 0) & (g2[:, 0] <= w - 1) & (g2[:, 1] >= 0) & (g2[:, 1] <= h - 1)
    g1h, g2h = np.r_[g1.T, np.ones((1, len(g1)))], np.r_[g2.T, np.ones((1, len(g2)))]
    near = np.minimum(pre_image(g2h, 0)[1], pre_image(g2h, 1)[1])
    own = np.isclose(np.where(plane == 0, depth2(g1h, 0), depth2(g1h, 1)), near)
    keep = inside & own
    grid = PlaneGrid(xy1=g1[keep].astype(np.float32), xy2=g2[keep].astype(np.float32),
                     plane=plane[keep], H=H, split=split)
    return img1, img2, F, grid


def epipolar_error(F, pts1, pts2) -> float:
    """Median over the correspondences of the symmetric point-to-line
    distance in px: the mean of x2's distance to the line F x1 and x1's
    distance to the line F^T x2."""
    F = np.asarray(F, np.float64)
    p1 = np.c_[np.asarray(pts1, np.float64), np.ones(len(pts1))]
    p2 = np.c_[np.asarray(pts2, np.float64), np.ones(len(pts2))]
    l2 = p1 @ F.T                     # lines in img2
    l1 = p2 @ F                       # lines in img1
    r = np.abs(np.sum(p2 * l2, 1))
    d = 0.5 * (r / np.linalg.norm(l2[:, :2], axis=1) + r / np.linalg.norm(l1[:, :2], axis=1))
    return float(np.median(d))
