"""What the port's parity tests need of the JAX package beyond its public
functions: its TPU route's detection on the CPU, and its RANSAC draws.

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
from unittest import mock

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mods_tpu import pipeline as jpipe
from mods_tpu.detect import detector as jdet
from mods_tpu.types import Keypoints as JKeypoints

KP_FIELDS = ("xy", "A", "s", "response", "valid")


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
    """The uniforms the JAX package's loransac_h draws from
    PRNGKey(seed), under the port's names (`loransac_h`'s `draws`): the
    first core's (k_core), the i-th adaptive sweep's (the i-th split of
    k_ad) and the second core's (the key left after the first split)."""

    def __init__(self, seed: int):
        key, self.k_core, self.k_ad = jax.random.split(jax.random.PRNGKey(seed), 3)
        self.k_core2 = key
        self.names = []

    def __call__(self, name, shape):
        self.names.append(name)
        if name.startswith("sweep"):
            k = self.k_ad
            for _ in range(int(name[5:]) + 1):
                k, sub = jax.random.split(k)
        else:
            core = self.k_core2 if name.endswith("2") else self.k_core
            k1, k2, _ = jax.random.split(core, 3)
            sub = k1 if name.startswith("u_sweep") else k2
        return torch.from_numpy(np.array(jax.random.uniform(sub, shape)))
