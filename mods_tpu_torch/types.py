"""Core data structures — fixed-shape structure-of-arrays of tensors.

Counterpart of the JAX package's types.py: every feature set is a padded
structure-of-arrays with a `valid` mask, with the same static shapes, so
that rows of the port and of the reference compare one to one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch


class _TensorFields:
    """`.to(device)`, field-wise mapping and a narrowed `valid` for the
    tensor dataclasses."""

    def map(self, fn):
        return type(self)(*[fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)])

    def to(self, device):
        return self.map(lambda x: x.to(device))

    def with_valid(self, valid: torch.Tensor):
        """The same rows, every other field the same tensor, with `valid`."""
        return dataclasses.replace(self, valid=valid)


@dataclass
class Keypoints(_TensorFields):
    """A padded batch of affine-covariant keypoints in one frame.

    xy:   [N,2] float32 (x, y) in pixels
    A:    [N,2,2] float32 affine shape (unit determinant at detection time)
    s:    [N] float32 scale (sigma) in pixels
    response: [N] float32 detector response
    valid: [N] bool padding mask
    """
    xy: torch.Tensor
    A: torch.Tensor
    s: torch.Tensor
    response: torch.Tensor
    valid: torch.Tensor

    @property
    def n(self) -> int:
        return self.xy.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()

    @staticmethod
    def empty(n: int, device=None) -> "Keypoints":
        return Keypoints(
            xy=torch.zeros((n, 2), device=device),
            A=torch.eye(2, device=device).expand(n, 2, 2).clone(),
            s=torch.ones((n,), device=device),
            response=torch.zeros((n,), device=device),
            valid=torch.zeros((n,), dtype=torch.bool, device=device))

    def take(self, idx: torch.Tensor, extra_valid=None) -> "Keypoints":
        v = self.valid[idx]
        if extra_valid is not None:
            v = v & extra_valid
        return Keypoints(self.xy[idx], self.A[idx], self.s[idx],
                         self.response[idx], v)

    def sanitize(self) -> "Keypoints":
        """Replace padding rows with benign values (xy=0, A=I, s=1), so
        that window origins computed from them stay inside the image."""
        v = self.valid
        eye = torch.eye(2, dtype=self.A.dtype, device=self.A.device)
        return Keypoints(
            xy=torch.where(v[:, None], self.xy, 0.0),
            A=torch.where(v[:, None, None], self.A, eye),
            s=torch.where(v, self.s, 1.0),
            response=torch.where(v, self.response, 0.0),
            valid=v)


@dataclass
class Features(_TensorFields):
    """Keypoints in the detection and the original frame + descriptors.
    desc: [N,D] float32."""
    det: Keypoints
    reproj: Keypoints
    desc: torch.Tensor

    @property
    def n(self) -> int:
        return self.det.n

    @property
    def valid(self) -> torch.Tensor:
        return self.det.valid

    def count(self) -> torch.Tensor:
        return self.det.count()

    @staticmethod
    def empty(n: int, d: int = 128, device=None) -> "Features":
        return Features(Keypoints.empty(n, device), Keypoints.empty(n, device),
                        torch.zeros((n, d), device=device))


@dataclass
class Tentatives(_TensorFields):
    """Tentative correspondences as parallel arrays padded to a fixed
    capacity with `valid`."""
    xy1: torch.Tensor      # [M,2]
    xy2: torch.Tensor      # [M,2]
    A1: torch.Tensor       # [M,2,2]
    A2: torch.Tensor       # [M,2,2]
    s1: torch.Tensor       # [M]
    s2: torch.Tensor       # [M]
    d1: torch.Tensor       # [M]  best descriptor distance
    d2: torch.Tensor       # [M]  FGINN distance
    ratio: torch.Tensor    # [M]  sqrt(d1/d2)
    valid: torch.Tensor    # [M] bool

    @property
    def m(self) -> int:
        return self.xy1.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()

    @staticmethod
    def empty(m: int, device=None) -> "Tentatives":
        z2 = torch.zeros((m, 2), device=device)
        z22 = torch.eye(2, device=device).expand(m, 2, 2).clone()
        z = torch.zeros((m,), device=device)
        return Tentatives(z2, z2, z22, z22, z, z, z, z, z,
                          torch.zeros((m,), dtype=torch.bool, device=device))


@dataclass
class MatchResult:
    """Output of geometric verification."""
    tentatives: Tentatives       # with the valid mask reduced to inliers
    H: torch.Tensor              # [3,3] estimated model
    n_inliers: torch.Tensor      # scalar int
    score: torch.Tensor          # scalar float32 MSAC score

    def to(self, device):
        return MatchResult(self.tentatives.to(device), self.H.to(device),
                           self.n_inliers.to(device), self.score.to(device))


_KP_FIELDS = ("xy", "A", "s", "response", "valid")


def concat_keypoints(kps: Sequence[Keypoints],
                     total: Optional[int] = None) -> Keypoints:
    """Concatenate padded keypoint sets (valid-first not required)."""
    out = Keypoints(*[torch.cat([getattr(k, f) for k in kps]) for f in _KP_FIELDS])
    return out if total is None else pad_keypoints(out, total)


def pad_keypoints(k: Keypoints, n: int) -> Keypoints:
    """Pad to n rows with invalid rows (xy 0, A 0, s 1)."""
    pad = n - k.n
    if pad == 0:
        return k
    if pad < 0:
        raise ValueError(f"cannot shrink {k.n} -> {n}")
    fill = lambda t, v: torch.cat([t, torch.full((pad,) + t.shape[1:], v,
                                                 dtype=t.dtype, device=t.device)])
    return Keypoints(xy=fill(k.xy, 0.0), A=fill(k.A, 0.0), s=fill(k.s, 1.0),
                     response=fill(k.response, 0.0), valid=fill(k.valid, False))


def compact_keypoints(k: Keypoints, n: Optional[int] = None) -> Keypoints:
    """Move valid entries to the front (stable); optionally resize to n."""
    order = torch.sort((~k.valid).to(torch.uint8), stable=True).indices
    out = k.take(order)
    if n is None or n == out.n:
        return out
    if n < out.n:
        return Keypoints(*[getattr(out, f)[:n] for f in _KP_FIELDS])
    return pad_keypoints(out, n)


def features_to_numpy(f: Features) -> Dict[str, np.ndarray]:
    """Dense (unpadded) numpy view for IO / host-side code."""
    v = f.valid.cpu().numpy()
    g = lambda t: t.detach().cpu().numpy()[v]
    return dict(xy=g(f.reproj.xy), A=g(f.reproj.A), s=g(f.reproj.s),
                response=g(f.reproj.response), det_xy=g(f.det.xy),
                det_A=g(f.det.A), det_s=g(f.det.s), desc=g(f.desc))
