"""What the port's parity tests need of the JAX package beyond its public
functions: its TPU route's detection on the CPU, its RANSAC draws, and the
tentative sets the verifier tests share.

The JAX package chooses Baumberg's sampler by backend: the Pallas kernels
on a TPU, an exact gather sampler elsewhere.  The port has the kernels'
semantics on every device (the kernels on the card, their plain versions
on the CPU), so the tests hold it against the TPU route: the JAX
package's own detect_keypoints, with its detector module told that the
backend is a TPU, so that its octave loop takes `engine="pallas"` and the
kernels run in interpret mode on the CPU.  (The hat engine,
`engine=True`, equals the kernels on windows of 104, not on the narrow
windows of small octaves, where it reads taps a kernel drops.)
`tpu_route_detection` puts that detection in place of the JAX package's
`detect_keypoints` for the duration of a test.
"""
import contextlib
import os
from unittest import mock

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mods_tpu import pipeline as jpipe
from mods_tpu.detect import detector as jdet
from mods_tpu import types as jtypes
from mods_tpu.types import Keypoints as JKeypoints
from mods_tpu_torch import types as ttypes

KP_FIELDS = ("xy", "A", "s", "response", "valid")
T_FIELDS = ("xy1", "xy2", "A1", "A2", "s1", "s2", "d1", "d2", "ratio", "valid")
DATA = os.path.join(os.path.dirname(__file__), "data")


class _TpuBackendJax:
    """The jax module as the detector module sees it on a TPU:
    default_backend() answers "tpu"; everything else is jax's."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


_DETECT_KEYPOINTS = jdet.detect_keypoints
_DETECT_ALL = jdet._detect_all_jit
# the octave loop in a jit of its own: its traces (the TPU route) never
# share a cache with the JAX package's own, which holds the CPU route
_DETECT_ALL_TPU = jax.jit(_DETECT_ALL.__wrapped__, static_argnames=(
    "fpar", "max_kp", "max_octave_cands", "reg_number"))


def jax_detect_engine(img, par, max_kp: int = 8192, max_octave_cands: int = 4096,
                      tilt: float = 1.0, zoom: float = 1.0, jit: bool = True
                      ) -> JKeypoints:
    """The JAX package's detect_keypoints as its TPU route runs it; with
    jit=False op by op, as the JAX package's own octave tests run it."""
    loop = _DETECT_ALL_TPU if jit else _DETECT_ALL.__wrapped__
    with mock.patch.object(jdet, "jax", _TpuBackendJax()), \
            mock.patch.object(jdet, "_detect_all_jit", loop):
        return _DETECT_KEYPOINTS(jnp.asarray(img), par, max_kp, max_octave_cands,
                                 tilt, zoom)


def tpu_route_detection(monkeypatch) -> None:
    """Every caller of the JAX package's detect_keypoints (the per-view
    pipeline, the atlas, which imports it when called) gets the TPU
    route's detection."""
    monkeypatch.setattr(jdet, "detect_keypoints", jax_detect_engine)
    monkeypatch.setattr(jpipe, "detect_keypoints", jax_detect_engine)


def to_jax_kp(kp) -> JKeypoints:
    return JKeypoints(*[jnp.asarray(getattr(kp, f).numpy()) for f in KP_FIELDS])


class JaxDraws:
    """The uniforms a JAX package verifier draws from PRNGKey(seed), under
    the port's names (the verifiers' `draws`), for one of three key trees:

    - "loransac" (loransac_h, loransac_f): key, k_core, k_ad =
      split(PRNGKey(seed), 3); a core's k1, k2, k3 = split(core key, 3) give
      "u_sweep" (k1) and "u_lo" (k2), and k_h, k_pp = split(k3) the
      degeneracy pass's "u_degen_h" and "u_degen_pp"; the first core's key
      is k_core, the second's (names ending in "2") the key left; the i-th
      adaptive sweep "sweep{i}" is the i-th split of k_ad;
    - "orsa" (orsa_filter): "orsa1", "orsa2" = split(PRNGKey(seed));
    - "2el" (ransac_h_2el): k1, k2 = split(PRNGKey(seed)); "u_2el" from k1,
      and "u_sweep", "u_lo" from the core key k2 as above."""

    def __init__(self, seed: int, tree: str = "loransac"):
        self.tree = tree
        self.root = jax.random.PRNGKey(seed)
        key, self.k_core, self.k_ad = jax.random.split(self.root, 3)
        self.k_core2 = key
        self.names = []

    def key(self, name):
        """The JAX key whose uniforms answer `name`."""
        if self.tree == "orsa":
            return jax.random.split(self.root)[{"orsa1": 0, "orsa2": 1}[name]]
        if self.tree == "2el":
            k1, core = jax.random.split(self.root)
            if name == "u_2el":
                return k1
        elif name.startswith("sweep"):
            k = self.k_ad
            for _ in range(int(name[5:]) + 1):
                k, sub = jax.random.split(k)
            return sub
        else:
            core = self.k_core2 if name.endswith("2") else self.k_core
            name = name[:-1] if name.endswith("2") else name
        k1, k2, k3 = jax.random.split(core, 3)
        if name.startswith("u_degen"):
            return jax.random.split(k3)[0 if name == "u_degen_h" else 1]
        return {"u_sweep": k1, "u_lo": k2}[name]

    def __call__(self, name, shape):
        self.names.append(name)
        return torch.from_numpy(np.array(jax.random.uniform(self.key(name), shape)))


@contextlib.contextmanager
def recording_uniforms():
    """While entered, each jax.random.uniform that the JAX package's
    functions call appends (shape, values) to the list yielded, in program
    order, also inside jit (an ordered debug callback).  The compilation
    caches are cleared on entry and exit, so that jitted functions trace
    anew with the recorder and drop it after."""
    seen = []
    uniform = jax.random.uniform

    def recording(key, shape=(), *args, **kw):
        out = uniform(key, shape, *args, **kw)
        jax.debug.callback(lambda v: seen.append((tuple(shape), np.asarray(v))), out,
                           ordered=True)
        return out

    jax.clear_caches()
    try:
        with mock.patch.object(jax.random, "uniform", recording):
            yield seen
            jax.effects_barrier()
    finally:
        jax.clear_caches()


def assert_draws_answer(draws, names, seen):
    """The uniforms recorded (`recording_uniforms`) are, in order, what
    `draws` answers to `names` at the recorded shapes."""
    assert len(seen) == len(names), (len(seen), names)
    for name, (shape, u) in zip(names, seen):
        np.testing.assert_array_equal(draws(name, shape).numpy(), u, err_msg=name)


# --------------------------------------------------------------------------- #
# tentative sets for the verifiers: lists of numpy arrays in T_FIELDS order
# --------------------------------------------------------------------------- #
def graf_tentatives(name):
    """The committed graf tentatives, "fwd" (65 valid of 128) or "rev"
    (78 of 128)."""
    d = np.load(os.path.join(DATA, f"fpath_graf_{name}.npz"))
    z = np.zeros_like(d["s1"])
    return [d[k] if k in d else z for k in T_FIELDS]


def tentative_arrays(xy1, xy2, A1=None, A2=None, s=2.0):
    """Tentatives of the correspondences (xy1, xy2): all valid, identity
    affines unless given, scale s."""
    m = len(xy1)
    eye = np.tile(np.eye(2, dtype=np.float32), (m, 1, 1))
    A1 = eye if A1 is None else A1
    A2 = eye if A2 is None else A2
    z = np.zeros(m, np.float32)
    return [np.asarray(xy1, np.float32), np.asarray(xy2, np.float32),
            np.asarray(A1, np.float32), np.asarray(A2, np.float32),
            np.full(m, s, np.float32), np.full(m, s, np.float32), z, z,
            np.full(m, 0.5, np.float32), np.ones(m, bool)]


def _camera_pair(angle, t):
    """K (f 700, 800 x 600) and a yaw `angle` with translation t: the true F."""
    K = np.array([[700.0, 0, 400.0], [0, 700.0, 300.0], [0, 0, 1.0]])
    R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                  [-np.sin(angle), 0, np.cos(angle)]])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F = np.linalg.inv(K).T @ (tx @ R) @ np.linalg.inv(K)
    return K, R, np.asarray(t), F / np.linalg.norm(F)


def _project(K, R, t, X):
    p1 = X @ K.T
    p2 = (X @ R.T + t) @ K.T
    return p1[:, :2] / p1[:, 2:], p2[:, :2] / p2[:, 2:]


def two_camera_tentatives(n_in=80, n_out=40, noise=0.3, seed=0):
    """Points in depth 4-12 seen by two cameras (the JAX package's
    test_epipolar scene): n_in true correspondences with Gaussian noise,
    n_out uniform outliers.  Returns (arrays, F_true)."""
    K, R, t, F = _camera_pair(0.15, [1.0, 0.15, 0.1])
    rng = np.random.default_rng(seed + 1)
    m = n_in + n_out
    xy1, xy2 = _project(K, R, t, rng.uniform([-3, -2, 4], [3, 2, 12], (m, 3)))
    xy2[:n_in] += rng.normal(0, noise, (n_in, 2))
    xy2[n_in:] = rng.uniform([0, 0], [800, 600], (n_out, 2))
    return tentative_arrays(xy1, xy2), F


def plane_scene_tentatives(n_plane=70, n_off=15, n_out=15, seed=3):
    """A dominant plane at depth 8 with off-plane points and outliers (the
    JAX package's test_degensac scene).  Returns (arrays, F_true); rows
    [0, n_plane) lie on the plane, the next n_off off it."""
    K, R, t, F = _camera_pair(0.12, [1.2, 0.1, 0.05])
    rng = np.random.default_rng(seed)
    Xp = np.c_[rng.uniform([-3, -2], [3, 2], (n_plane, 2)), np.full(n_plane, 8.0)]
    Xo = rng.uniform([-3, -2, 4.5], [3, 2, 14], (n_off, 3))
    xy1, xy2 = _project(K, R, t, np.r_[Xp, Xo])
    xy1 = np.r_[xy1, rng.uniform([0, 0], [800, 600], (n_out, 2))]
    xy2 = np.r_[xy2, rng.uniform([0, 0], [800, 600], (n_out, 2))]
    return tentative_arrays(xy1, xy2), F


def within(n_port, n_jax):
    """Inlier counts within max(2, 3 %) of the JAX package's."""
    return abs(n_port - n_jax) <= max(2, 0.03 * n_jax)


def padded(arrays, m: int = 128):
    """The tentatives padded with invalid zero rows to m rows (one shape for
    every set, so that the JAX package compiles its verifiers once)."""
    n = len(arrays[0])
    return [np.concatenate([a, np.zeros((m - n,) + a.shape[1:], a.dtype)]) for a in arrays]


def jax_tentatives(arrays):
    return jtypes.Tentatives(*[jnp.asarray(a) for a in arrays])


def torch_tentatives(arrays):
    return ttypes.Tentatives(*[torch.from_numpy(np.array(a)) for a in arrays])


# --------------------------------------------------------------------------- #
# match_images on a two-plane scene's features, in both packages
# --------------------------------------------------------------------------- #
def plane_features(seed=0, n=160, n_out=40):
    """Features of both images on the two planes of a 320x400
    two_plane_pair, with LAFs that each plane's homography maps (A2 its
    Jacobian at x1), n_out of image 2's moved at random; descriptors
    matched up to noise."""
    from mods_tpu_torch.testing import two_plane_pair
    _, _, _, g = two_plane_pair(320, 400, 2)
    rng = np.random.default_rng(seed)
    i = rng.choice(len(g.xy1), n, replace=False)
    xy1, xy2, Hs = g.xy1[i], g.xy2[i].copy(), g.H[g.plane[i]]
    p = np.einsum("nij,nj->ni", Hs, np.c_[xy1, np.ones(n)])
    J = (Hs[:, :2, :2] - (p[:, :2] / p[:, 2:])[:, :, None] * Hs[:, 2:3, :2]) \
        / p[:, 2, None, None]
    d = np.sqrt(np.abs(np.linalg.det(J)))
    A2 = (J / d[:, None, None]).astype(np.float32)
    s2 = (3.0 * d).astype(np.float32)
    xy2[:n_out] = rng.uniform(0, 320, (n_out, 2))
    desc = rng.integers(0, 255, (n, 128)).astype(np.float32)
    d2 = np.clip(desc + rng.normal(0, 2, desc.shape), 0, 255).astype(np.float32)
    eye = np.tile(np.eye(2, dtype=np.float32), (n, 1, 1))
    resp = rng.uniform(1, 100, n).astype(np.float32)
    return [([xy1, eye, np.full(n, 3.0, np.float32), resp, np.ones(n, bool)], desc),
            ([xy2, A2, s2, resp, np.ones(n, bool)], d2)]


def match_images_both(ver_type):
    """`plane_features` through the JAX package's match_images and the
    port's (on the CPU, with JAX's draws), pre_extracted, at Config()
    with the MODS schedule, on a 320x400 image.  Returns ((jax result, port
    result), plane) with plane(result) the final inliers on each plane."""
    import dataclasses
    from mods_tpu import config as jconfig
    from mods_tpu.twoview import match_images as jmatch_images
    from mods_tpu_torch import config as tconfig
    from mods_tpu_torch import twoview
    from mods_tpu_torch.testing import mods_schedule, two_plane_pair
    sets = plane_features()
    jfeat = [jtypes.Features(jtypes.Keypoints(*map(jnp.asarray, a)),
                             jtypes.Keypoints(*map(jnp.asarray, a)), jnp.asarray(d))
             for a, d in sets]
    tfeat = [ttypes.Features(ttypes.Keypoints(*map(torch.from_numpy, a)),
                             ttypes.Keypoints(*map(torch.from_numpy, a)),
                             torch.from_numpy(d)) for a, d in sets]
    jcfg = jconfig.Config()
    cfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    cfg.iters = mods_schedule()
    jcfg.iters = [jconfig.IterationStep(**dataclasses.asdict(s)) for s in cfg.iters]
    img = np.zeros((320, 400), np.float32)
    j = jmatch_images(img, img, jcfg, pre_extracted=tuple(jfeat), ver_type=ver_type)
    tree = "orsa" if ver_type == "ORSA" else "loransac"
    t = twoview.match_images(img, img, cfg, pre_extracted=tuple(tfeat), device="cpu",
                             ver_type=ver_type, draws=JaxDraws(cfg.ransac.seed, tree))
    grid = two_plane_pair(320, 400, 2)[3]

    def plane(r):
        tt = r.final.tentatives
        keep = tt.valid.numpy()
        on = grid.plane_of(tt.xy1.numpy()[keep], tt.xy2.numpy()[keep])
        return [int((on == i).sum()) for i in (0, 1)]
    return (j, t), plane


def assert_colocated_descriptors(t, j):
    """Descriptors of keypoints at the same place (within 0.5 px; several
    rows may share one, so the closest descriptor there counts): at least
    95 % of the port's keypoints have a partner, at least 90 % of those
    agree within 1 and all within 8.  (Given the same keypoints the
    descriptors agree within 1; detection's rounding turns a few frames by
    a little, which moves their descriptors by a few levels.)"""
    tv, jv = t.det.valid.numpy(), np.asarray(j.det.valid)
    xt, xj = t.det.xy.numpy()[tv], np.asarray(j.det.xy)[jv]
    dt, dj = t.desc.numpy()[tv], np.asarray(j.desc)[jv]
    dist = np.linalg.norm(xt[:, None] - xj[None], axis=-1)
    hit = dist.min(1) < 0.5
    assert hit.mean() >= 0.95, hit.mean()
    err = np.array([np.abs(dj[dist[i] < 0.5] - dt[i]).max(axis=1).min()
                    for i in np.nonzero(hit)[0]])
    assert (err <= 1.0).mean() >= 0.9 and err.max() <= 8.0, (
        (err > 1.0).sum(), err.max())
