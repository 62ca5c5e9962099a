"""Synthetic patch-pair generation for descriptor training.

Counterpart of the JAX package's desc/data.py.  Training data of the
reference (Brown / HPatches) is not available offline; this module
synthesizes anchor / positive patch pairs the way the matching pipeline
stresses a descriptor:

 1. base textures: photos shipped inside installed Python packages, a
    photo-thumbnail collage, and procedural composites (polygons,
    gratings, filtered noise, glyphs, lines);
 2. anchor frames: Hessian-Affine detections on each base image (the
    pipeline's detector: the Baumberg kernels on the card);
 3. positives: the same keypoint re-sampled under a random detection-noise
    warp plus photometric jitter (`generate_pairs`), or correspondences
    of the deep pipeline (Hessian + AffNet + OriNet) across
    homography-warped views (`generate_pairs_pipeline`).  Patches come
    from the mip patch engine (the resample kernels on the card).

Patches are 32x32, measurement region mrSize = 5.1962 (3 sqrt 3), the
deep pipeline's wire format.  Every random draw comes from one numpy
Generator in the JAX package's order, so that equal frames give equal
pairs; the pairs come back as numpy arrays, and the caches of the two
trainers are interchangeable.

Where the JAX package reads the reference's INI files, these functions
take a `cfg` (Config(), or deep_config() for the pipeline pairs, by
default); where it reads the graf pair from the reference's directory,
they take that directory (`graf_dir`).
"""
from __future__ import annotations

import copy
import math
import os
import sysconfig
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device

MR_SIZE = 5.1962
PATCH = 32
# the most keypoints sampled at once (the JAX package's fixed pool)
SAMPLE_POOL = 4096
GRAF_PAIR = ("graf1.png", "graf6.png")


def _perlin_like(rng: np.random.Generator, size: int) -> np.ndarray:
    """Multi-octave smoothed-noise texture in [0, 255]."""
    img = np.zeros((size, size), np.float32)
    for octave in range(1, 6):
        cells = 2 ** octave
        g = rng.normal(0, 1, (cells, cells)).astype(np.float32)
        # bilinear upsample to full size
        idx = np.linspace(0, cells - 1, size)
        x0 = np.clip(idx.astype(int), 0, cells - 2)
        fx = idx - x0
        rows = g[x0][:, x0] * (1 - fx)[None, :] + g[x0][:, x0 + 1] * fx[None, :]
        rows2 = g[x0 + 1][:, x0] * (1 - fx)[None, :] + g[x0 + 1][:, x0 + 1] * fx[None, :]
        up = rows * (1 - fx)[:, None] + rows2 * fx[:, None]
        img += up / octave
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img


def _shapes(rng: np.random.Generator, size: int) -> np.ndarray:
    """Random flat-shaded polygons / ellipses over a gradient background."""
    import cv2
    gx = np.linspace(0, 255, size, dtype=np.float32)
    img = np.tile(gx * rng.uniform(0.3, 1.0), (size, 1))
    if rng.random() < 0.5:
        img = img.T.copy()
    for _ in range(rng.integers(12, 40)):
        shade = float(rng.uniform(0, 255))
        kind = rng.random()
        if kind < 0.5:
            npts = int(rng.integers(3, 7))
            pts = rng.integers(0, size, (npts, 2)).astype(np.int32)
            cv2.fillPoly(img, [pts], shade)
        else:
            c = tuple(int(v) for v in rng.integers(0, size, 2))
            axes = tuple(int(v) for v in rng.integers(4, size // 3, 2))
            ang = float(rng.uniform(0, 180))
            cv2.ellipse(img, c, axes, ang, 0, 360, shade, -1)
    return img.astype(np.float32)


def _text_texture(rng: np.random.Generator, size: int) -> np.ndarray:
    """Dense random glyphs over a shaded background: high-frequency
    structured texture (poster / graffiti-like edge statistics)."""
    import cv2
    img = np.full((size, size), int(rng.uniform(40, 220)), np.uint8)
    glyphs = "abcdefghijklmnopqrstuvwxyzABCDEFGHJKLMNPQRSTUVWXYZ0123456789#@&%?!"
    for _ in range(rng.integers(40, 120)):
        txt = "".join(rng.choice(list(glyphs))
                      for _ in range(rng.integers(1, 6)))
        org = tuple(int(v) for v in rng.integers(0, size, 2))
        fs = float(rng.uniform(0.5, 3.0))
        shade = int(rng.uniform(0, 255))
        th = int(rng.integers(1, 4))
        cv2.putText(img, txt, org, int(rng.integers(0, 8)), fs, shade, th,
                    cv2.LINE_AA)
    return img.astype(np.float32)


def _lines_texture(rng: np.random.Generator, size: int) -> np.ndarray:
    """Random line segments: man-made structure statistics."""
    import cv2
    img = _perlin_like(rng, size) * 0.4 + 60.0
    for _ in range(rng.integers(30, 90)):
        p1 = tuple(int(v) for v in rng.integers(0, size, 2))
        p2 = tuple(int(v) for v in rng.integers(0, size, 2))
        cv2.line(img, p1, p2, float(rng.uniform(0, 255)),
                 int(rng.integers(1, 5)), cv2.LINE_AA)
    return img.astype(np.float32)


def _site_packages() -> str:
    """The directory of this interpreter's installed packages."""
    return sysconfig.get_paths()["purelib"]


# photos, screenshots, rendered scenes and game textures that installed
# packages ship (real edge statistics), under _site_packages()
_PHOTO_GLOBS = (
    "matplotlib/mpl-data/sample_data/*.jpg",
    "sklearn/datasets/images/*.jpg",
    "pygame/examples/data/*.jpg",
    "pygame/docs/generated/_images/*.jpg",
    "pygame/docs/generated/_images/*.png",
    # labmaze game textures: 1024^2 floor / wall / sky renders
    "labmaze/assets/*/*.png",
)
# a photo-thumbnail collage shipped in a package
_COLLAGE = "aqt/jax_legacy/jax/imagenet/imagenet.png"


def _discover_photos(max_n: int = 160) -> List[str]:
    """Natural and structured images that installed packages ship, in a
    fixed order; near-duplicate twins (names differing in trailing digits),
    small and flat images are skipped.  The graf pair is never among
    them."""
    import glob
    import cv2
    out, seen = [], set()
    for pat in _PHOTO_GLOBS:
        for p in sorted(glob.glob(os.path.join(_site_packages(), pat))):
            stem = os.path.basename(p).rstrip("1234567890")
            if stem in seen:
                continue
            im = cv2.imread(p)
            if im is None:
                continue
            h, w = im.shape[:2]
            if min(h, w) < 200 or im.std() < 25:
                continue
            seen.add(stem)
            out.append(p)
            if len(out) >= max_n:
                return out
    return out


def _collage_tiles(size: int, max_tiles: int = 24) -> List[np.ndarray]:
    """size x size tiles of the collage with some texture (std > 25): at
    32x32 patch scale, real-photo statistics."""
    import cv2
    path = os.path.join(_site_packages(), _COLLAGE)
    im = cv2.imread(path) if os.path.exists(path) else None
    if im is None:
        return []
    g = im.astype(np.float32).mean(axis=2)
    h, w = g.shape
    tiles = []
    for y in range(0, h - size + 1, size):
        for x in range(0, w - size + 1, size):
            t = g[y:y + size, x:x + size]
            if t.std() > 25:
                tiles.append(np.ascontiguousarray(t))
            if len(tiles) >= max_tiles:
                return tiles
    return tiles


def make_base_images(n: int, size: int = 512, seed: int = 0,
                     include_graf: bool = True,
                     graf_dir: Optional[str] = None) -> List[np.ndarray]:
    """n float32 grey images: the graf pair (include_graf, read from
    graf_dir where it is there), collage tiles, photos resized to
    size x size, then procedural textures drawn from default_rng(seed)."""
    import cv2
    rng = np.random.default_rng(seed)
    imgs: List[np.ndarray] = []
    if include_graf and graf_dir is not None:
        for name in GRAF_PAIR:
            im = cv2.imread(os.path.join(graf_dir, name))
            if im is not None:
                imgs.append(im.astype(np.float32).mean(axis=2))
    for t in _collage_tiles(size):
        if len(imgs) >= n:
            break
        imgs.append(t)
    for p in _discover_photos():
        if len(imgs) >= n:
            break
        im = cv2.imread(p)
        if im is not None and min(im.shape[:2]) >= 128:
            g = im.astype(np.float32).mean(axis=2)
            imgs.append(cv2.resize(g, (size, size)))
    while len(imgs) < n:
        mode = rng.random()
        if mode < 0.25:
            img = _shapes(rng, size)
        elif mode < 0.45:
            img = _perlin_like(rng, size)
        elif mode < 0.65:
            img = _text_texture(rng, size)
        elif mode < 0.8:
            img = _lines_texture(rng, size)
        else:
            img = 0.5 * _shapes(rng, size) + 0.5 * _perlin_like(rng, size)
        # mild blur so gradients are not aliased
        img = cv2.GaussianBlur(img, (0, 0), rng.uniform(0.6, 1.2))
        imgs.append(img.astype(np.float32))
    return imgs


def detect_anchor_frames(img: np.ndarray, max_kp: int = 512, cfg=None,
                         device=None):
    """Hessian-Affine detections (xy, A, s) of the valid rows, as numpy,
    on a base image: cfg.hessian (Config()'s by default; the reference's
    config_affori_classic.ini through config.load_config), at most max_kp
    keypoints from 2048 candidates an octave."""
    from ..config import Config
    from ..detect.detector import detect_keypoints
    cfg = Config() if cfg is None else cfg
    dev = resolve_device(device)
    kp = detect_keypoints(torch.as_tensor(img, dtype=torch.float32).to(dev),
                          cfg.hessian, max_kp=max_kp, max_octave_cands=2048)
    valid = kp.valid.cpu().numpy()
    return (kp.xy.cpu().numpy()[valid], kp.A.cpu().numpy()[valid],
            kp.s.cpu().numpy()[valid])


def _jitter_frames(rng: np.random.Generator, A: np.ndarray, s: np.ndarray,
                   xy: np.ndarray, max_rot: float = math.pi,
                   max_aniso: float = 1.35, max_scale: float = 1.25,
                   max_shift: float = 1.2):
    """A random detection-noise warp of measurement frames: rotation,
    anisotropy, scale and a shift in units of the scale."""
    n = len(s)
    th = rng.uniform(-max_rot, max_rot, n)
    ca, sa = np.cos(th), np.sin(th)
    R = np.stack([np.stack([ca, -sa], -1), np.stack([sa, ca], -1)], -2)
    an = np.exp(rng.uniform(-np.log(max_aniso), np.log(max_aniso), n))
    D = np.zeros((n, 2, 2), np.float32)
    D[:, 0, 0] = an
    D[:, 1, 1] = 1.0 / an
    sc = np.exp(rng.uniform(-np.log(max_scale), np.log(max_scale), n))
    A2 = np.einsum("nij,njk,n->nik", A @ R, D, sc).astype(np.float32)
    xy2 = xy + rng.uniform(-max_shift, max_shift, (n, 2)) * s[:, None]
    return A2, xy2.astype(np.float32)


def _sample(img: np.ndarray, xy: np.ndarray, A: np.ndarray, s: np.ndarray,
            device=None) -> np.ndarray:
    """32x32 patches of the first SAMPLE_POOL frames from the image's mip
    pyramid, at the pipeline's descriptor step A * s * (2*int(mrSize)+1)/32
    (models/flagship.py), with the engine's "blend" anti-aliasing (the JAX
    package's default there)."""
    from ..ops import patch_engine as pe
    dev = resolve_device(device)
    k = float(2 * int(MR_SIZE) + 1) / PATCH
    pyr = pe.build_mip_pyramid(torch.as_tensor(img, dtype=torch.float32).to(dev))
    m = min(len(s), SAMPLE_POOL)
    step = torch.from_numpy(np.asarray(A[:m], np.float32)).to(dev) * \
        (k * torch.from_numpy(np.asarray(s[:m], np.float32)).to(dev))[:, None, None]
    xyt = torch.from_numpy(np.asarray(xy[:m], np.float32)).to(dev)
    return pe.sample_patches(pyr, xyt, step, PATCH, blend="blend").cpu().numpy()


def _photometric(rng: np.random.Generator, p: np.ndarray) -> np.ndarray:
    """Per-patch gain and bias, and sensor noise, clipped to 0..255."""
    n = len(p)
    gain = rng.uniform(0.6, 1.4, (n, 1, 1)).astype(np.float32)
    bias = rng.uniform(-30, 30, (n, 1, 1)).astype(np.float32)
    noise = rng.normal(0, rng.uniform(1, 6), p.shape).astype(np.float32)
    return np.clip(p * gain + bias + noise, 0, 255)


def generate_pairs(n_pairs: int, seed: int = 0, n_images: int = 24,
                   rot_jitter: float = 0.35, draws_per_kp: int = 4,
                   include_graf: bool = True, cfg=None, device=None,
                   graf_dir: Optional[str] = None,
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(anchors, positives, ids): patches [n_pairs, 32, 32] float32 in
    0..255 and ids [n_pairs] int64 naming the source keypoint
    (image * 1e6 + detection).

    Keypoints are drawn with replacement (draws_per_kp a detection on
    average), so one physical point appears several times under different
    jitter; `ids` keeps those copies out of hardest-negative mining.
    rot_jitter: residual rotation noise (radians) between anchor and
    positive: the pipeline estimates orientation before describing.
    cfg: the detector's configuration (detect_anchor_frames)."""
    rng = np.random.default_rng(seed)
    imgs = make_base_images(n_images, seed=seed, include_graf=include_graf,
                            graf_dir=graf_dir)
    anchors, positives, ids = [], [], []
    need = n_pairs
    for img_i, img in enumerate(imgs):
        if need <= 0:
            break
        xy, A, s = detect_anchor_frames(img, cfg=cfg, device=device)
        if len(s) < 8:
            continue
        take = max(32, min(draws_per_kp * len(s),
                           need // max(1, n_images - len(anchors))))
        sel = rng.choice(len(s), take, replace=True)
        xy, A, s = xy[sel], A[sel], s[sel]
        kp_id = img_i * 1_000_000 + sel.astype(np.int64)
        # the anchor gets a small jitter too (detections are never exact)
        Aa, xya = _jitter_frames(rng, A, s, xy, max_rot=rot_jitter / 2,
                                 max_aniso=1.15, max_scale=1.1, max_shift=0.5)
        Ap, xyp = _jitter_frames(rng, A, s, xy, max_rot=rot_jitter,
                                 max_aniso=1.35, max_scale=1.25, max_shift=1.2)
        pa = _photometric(rng, _sample(img, xya, Aa, s, device))
        pp = _photometric(rng, _sample(img, xyp, Ap, s, device))
        # drop nearly flat patches (no signal to learn from)
        keep = pa.std(axis=(1, 2)) > 4.0
        anchors.append(pa[keep])
        positives.append(pp[keep])
        ids.append(kp_id[keep])
        need -= int(keep.sum())
    a = np.concatenate(anchors)[:n_pairs]
    p = np.concatenate(positives)[:n_pairs]
    i = np.concatenate(ids)[:n_pairs]
    return a.astype(np.float32), p.astype(np.float32), i


# --------------------------------------------------------------------------- #
# Pipeline-correspondence pairs (homography self-supervision)
# --------------------------------------------------------------------------- #
def _random_homography(rng: np.random.Generator, size: int):
    """A graf-like viewpoint change and its anti-alias parameters (t, psi)
    or None: a 4-corner perspective perturbation (40 %), or an affine tilt
    t in [1.5, 6.5] along a random axis (60 % of tilts in [3, 6.5]) with a
    small projective part; a global rotation in both."""
    import cv2
    ctr = size / 2.0
    th = rng.uniform(-math.pi, math.pi)
    c, s = math.cos(th), math.sin(th)
    R = np.array([[c, -s, ctr - c * ctr + s * ctr],
                  [s, c, ctr - s * ctr - c * ctr],
                  [0, 0, 1]], np.float64)
    if rng.random() < 0.4:
        m = 0.30 * size
        src = np.float32([[0, 0], [size, 0], [size, size], [0, size]])
        dst = src + rng.uniform(-m, m, (4, 2)).astype(np.float32)
        H = cv2.getPerspectiveTransform(src, dst)
        aa = None
    else:
        if rng.random() < 0.6:
            t = math.exp(rng.uniform(math.log(3.0), math.log(6.5)))
        else:
            t = math.exp(rng.uniform(math.log(1.5), math.log(3.0)))
        psi = rng.uniform(0, math.pi)
        cp, sp = math.cos(psi), math.sin(psi)
        sc = math.exp(rng.uniform(-0.35, 0.25))
        Rp = np.array([[cp, -sp, 0], [sp, cp, 0], [0, 0, 1]])
        D = np.diag([sc / t, sc, 1.0])
        A = Rp.T @ D @ Rp
        # recenter so that the warped content stays near the canvas
        Hc = np.eye(3)
        Hc[:2, 2] = -ctr
        Hu = np.eye(3)
        Hu[:2, 2] = ctr
        H = Hu @ A @ Hc
        H[2, 0] = rng.uniform(-0.3, 0.3) / size
        H[2, 1] = rng.uniform(-0.3, 0.3) / size
        aa = (t, psi)
    return (R @ H).astype(np.float64), aa


def _aa_preblur(img: np.ndarray, aa) -> np.ndarray:
    """Directional anti-alias blur before a t-fold minifying warp (ASIFT
    semantics: sigma = 0.8 sqrt(t^2 - 1) along the compressed axis)."""
    import cv2
    if aa is None:
        return img
    t, psi = aa
    if t < 1.15:
        return img
    sigma = 0.8 * math.sqrt(t * t - 1.0)
    ks = int(6 * sigma + 1) | 1
    g = cv2.getGaussianKernel(ks, sigma)
    K = np.zeros((ks, ks), np.float32)
    K[ks // 2, :] = g[:, 0]
    M = cv2.getRotationMatrix2D((ks // 2, ks // 2), -math.degrees(psi), 1.0)
    K = cv2.warpAffine(K, M, (ks, ks))
    K /= max(K.sum(), 1e-9)
    return cv2.filter2D(img, -1, K)


def _photometric_image(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """A camera-like nuisance chain: gain / bias, gamma, optics blur, sensor
    noise, JPEG blocking."""
    import cv2
    out = img * rng.uniform(0.65, 1.4) + rng.uniform(-25, 25)
    if rng.random() < 0.7:
        g = math.exp(rng.uniform(math.log(0.6), math.log(1.6)))
        out = 255.0 * np.power(np.clip(out, 0, 255) / 255.0, g)
    if rng.random() < 0.5:
        out = cv2.GaussianBlur(out, (0, 0), rng.uniform(0.4, 1.1))
    out = out + rng.normal(0, rng.uniform(0.5, 4.0), out.shape)
    out = np.clip(out, 0, 255).astype(np.float32)
    if rng.random() < 0.5:
        q = int(rng.integers(45, 95))
        ok, buf = cv2.imencode(".jpg", out.astype(np.uint8),
                               [cv2.IMWRITE_JPEG_QUALITY, q])
        if ok:
            out = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE).astype(np.float32)
    return out


def _deep_frames(img: np.ndarray, cfg, max_kp: int, device=None):
    """The deep pipeline's frame chain on one view: Hessian detection ->
    AffNet shape -> OriNet orientation.  (image tensor, mip pyramid or None
    on the reference route, then xy, A, s and valid of every row as
    numpy)."""
    from ..detect.detector import detect_keypoints
    from ..ops import patch_engine as pe
    from .cnn import _use_engine, affnet_adapt, orinet_orient
    dev = resolve_device(device)
    dimg = torch.as_tensor(img, dtype=torch.float32).to(dev)
    pyr = pe.build_mip_pyramid(dimg) if _use_engine(cfg, dev) else None
    kp = detect_keypoints(dimg, cfg.hessian, max_kp=max_kp, max_octave_cands=max_kp)
    kp = affnet_adapt(dimg, kp, cfg, pyr=pyr)
    kp = orinet_orient(dimg, kp, cfg, pyr=pyr)
    return (dimg, pyr, kp.xy.cpu().numpy(), kp.A.cpu().numpy(), kp.s.cpu().numpy(),
            kp.valid.cpu().numpy())


def _deep_patches(dimg: torch.Tensor, pyr, xy, A, s, cfg) -> np.ndarray:
    """32x32 descriptor patches of the first SAMPLE_POOL frames, from the
    deep pipeline's sampler: the engine route (cnn.cnn_patches with the
    "blend" anti-aliasing, the JAX package's default there) or the
    reference route (cnn.reference_patches), as cnn._use_engine picks."""
    from ..types import Keypoints
    from .cnn import _use_engine, cnn_patches, reference_patches
    dev = dimg.device
    m = min(len(s), SAMPLE_POOL)
    t = lambda a: torch.from_numpy(np.asarray(a[:m], np.float32)).to(dev)
    valid = torch.ones(m, dtype=torch.bool, device=dev)
    if _use_engine(cfg, dev):
        p = cnn_patches(pyr, t(xy), t(A), t(s), valid, cfg.hardnet.mrSize, PATCH,
                        blend="blend")
    else:
        kp = Keypoints(t(xy), t(A), t(s), torch.zeros(m, device=dev), valid)
        p, _ = reference_patches(dimg, kp, cfg.hardnet.mrSize, PATCH)
    return p.cpu().numpy()


def _correspondences(rng, xy1, s1, xy2, s2, H, max_dist: float = 2.0,
                     max_srat: float = 1.45) -> np.ndarray:
    """[m, 2] index pairs (view 1, view 2) of mutual-nearest matches of
    view-2 detections mapped through H^-1 into view 1, gated by centre
    distance and the Jacobian-corrected scale ratio."""
    Hi = np.linalg.inv(H)
    ph = np.concatenate([xy2, np.ones((len(xy2), 1))], 1) @ Hi.T
    w = ph[:, 2:3]
    xy2in1 = ph[:, :2] / w
    # local scale change of H^-1 at each point: |det J| ** 0.5
    J11 = Hi[0, 0] - xy2in1[:, 0] * Hi[2, 0]
    J12 = Hi[0, 1] - xy2in1[:, 0] * Hi[2, 1]
    J21 = Hi[1, 0] - xy2in1[:, 1] * Hi[2, 0]
    J22 = Hi[1, 1] - xy2in1[:, 1] * Hi[2, 1]
    detJ = np.abs(J11 * J22 - J12 * J21) / (w[:, 0] ** 2)
    s2in1 = s2 * np.sqrt(np.maximum(detJ, 1e-12))
    if len(xy1) == 0 or len(xy2) == 0:
        return np.zeros((0, 2), np.int64)
    d = np.linalg.norm(xy1[:, None, :] - xy2in1[None, :, :], axis=-1)
    srat = np.maximum(s1[:, None] / s2in1[None, :], s2in1[None, :] / s1[:, None])
    ok = (d < max_dist) & (srat < max_srat)
    d = np.where(ok, d, np.inf)
    nn12 = np.argmin(d, axis=1)
    nn21 = np.argmin(d, axis=0)
    i1 = np.arange(len(xy1))
    mutual = (nn21[nn12] == i1) & np.isfinite(d[i1, nn12])
    return np.stack([i1[mutual], nn12[mutual]], axis=1)


def generate_pairs_pipeline(n_pairs: int, seed: int = 0, n_images: int = 96,
                            views_per_image: int = 3, max_kp: int = 2048,
                            size: int = 512, include_graf: bool = False,
                            cfg=None, device=None, graf_dir: Optional[str] = None,
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(anchors, positives, ids) harvested by running the deep pipeline
    (Hessian + AffNet + OriNet) on homography-warped views of each base
    image and keeping the geometrically verified correspondences: the
    nuisances are the test-time ones (localization error, AffNet and OriNet
    residuals, resampling, photometric noise).

    cfg: the detector and CNN configuration (testing.deep_config() by
    default; the reference's config_aff_ori_desc_zeromq.ini through
    config.load_config), copied, with max_keypoints and max_octave_cands
    set to max_kp."""
    import cv2
    from ..testing import deep_config
    rng = np.random.default_rng(seed)
    cfg = copy.deepcopy(deep_config() if cfg is None else cfg)
    cfg.max_keypoints = max_kp
    cfg.max_octave_cands = max_kp
    imgs = make_base_images(n_images, size=size, seed=seed,
                            include_graf=include_graf, graf_dir=graf_dir)
    anchors, positives, ids = [], [], []
    total = 0
    t0 = time.time()
    for img_i, img in enumerate(imgs):
        if total >= n_pairs:
            break
        if img_i and img_i % 8 == 0:
            print(f"  [pipeline-pairs] image {img_i}/{len(imgs)} "
                  f"pairs={total} ({time.time() - t0:.0f}s)", flush=True)
        base = _photometric_image(rng, img)
        d1, p1, xy1, A1, s1, v1 = _deep_frames(base, cfg, max_kp, device)
        pat1 = None
        for _ in range(views_per_image):
            H, aa = _random_homography(rng, size)
            warped = cv2.warpPerspective(
                _aa_preblur(img, aa), H, (size, size),
                flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
            warped = _photometric_image(rng, warped)
            d2, p2, xy2, A2, s2, v2 = _deep_frames(warped, cfg, max_kp, device)
            iv1 = np.where(v1)[0]
            iv2 = np.where(v2)[0]
            m = _correspondences(rng, xy1[iv1], s1[iv1], xy2[iv2], s2[iv2], H)
            if len(m) == 0:
                continue
            if pat1 is None:
                pat1 = _deep_patches(d1, p1, xy1[v1], A1[v1], s1[v1], cfg)
            pat2 = _deep_patches(d2, p2, xy2[v2], A2[v2], s2[v2], cfg)
            a = pat1[m[:, 0]]
            p = pat2[m[:, 1]]
            keep = a.std(axis=(1, 2)) > 4.0
            anchors.append(a[keep])
            positives.append(p[keep])
            ids.append(img_i * 1_000_000 + iv1[m[:, 0]][keep].astype(np.int64))
            total += int(keep.sum())
    a = np.concatenate(anchors)[:n_pairs]
    p = np.concatenate(positives)[:n_pairs]
    i = np.concatenate(ids)[:n_pairs]
    return a.astype(np.float32), p.astype(np.float32), i
