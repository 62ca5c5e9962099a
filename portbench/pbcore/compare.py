"""The comparison that decides `correct`: the program's answer for one
pool pair of the window against the plain reference's answer for the same
pair, the same configuration and the same RANSAC draws.

`summarize` takes what a MODS run produced (a TwoViewResult of the program
or of the reference) to host arrays; `numbers` compares two summaries and
gives every candidate number; a cell's limits file names those compared,
each with its limit (`judge`).  Under LORANSACF the final model is a
fundamental matrix (`H` holds F): `F_gap_px` judges it."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .pairs import corner_error

# two rows are the same keypoint when their position (px) and affine frame
# in the image lie within this distance (the frames of one keypoint's
# orientations lie farther apart)
ROW_TOL = 1e-2


def _host(t):
    return t.detach().to("cpu").numpy()


def summarize(res, descriptor: str) -> Dict:
    """Counts per step, the final H (or F) and inliers, the final inliers'
    correspondences (x1, y1, x2, y2), and for each image the rows of every
    feature set of `descriptor` (keypoint position and affine frame in the
    image, validity, descriptor), in the order the run made them."""
    out = dict(steps=int(res.steps_done), per_step=[dict(d) for d in res.per_step],
               H=None if res.H is None else np.asarray(res.H, np.float64),
               inliers=int(res.inliers), inlier_xy=np.zeros((0, 4)), images=[])
    if res.final is not None:
        t = res.final.tentatives
        v = _host(t.valid).astype(bool)
        out["inlier_xy"] = np.concatenate([_host(t.xy1)[v], _host(t.xy2)[v]],
                                          1).astype(np.float64)
    for rep in (res.rep1, res.rep2):
        sets = []
        if rep is not None:
            for det in sorted(rep.store):
                for f in rep.store[det].get(descriptor, []):
                    sets.append(dict(xy=_host(f.reproj.xy),
                                     A=_host(f.reproj.A).reshape(-1, 4),
                                     valid=_host(f.det.valid), desc=_host(f.desc)))
        out["images"].append(sets)
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def _rows(sets):
    """An image's valid rows over all its feature sets: keys (x, y and the
    affine frame in the image) and descriptors."""
    keys, desc = [], []
    for s in sets:
        v = s["valid"].astype(bool)
        keys.append(np.concatenate([s["xy"][v], s["A"][v]], 1).astype(np.float64))
        desc.append(s["desc"][v])
    if not keys:
        return np.zeros((0, 6)), np.zeros((0, 1), np.float32)
    return np.concatenate(keys), np.concatenate(desc)


def epipolar_px(F: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """The symmetric epipolar distance in px of each correspondence
    (x1, y1, x2, y2) under F (x2^T F x1 = 0): the larger of the distances
    of x2 to the line F x1 and of x1 to the line F^T x2."""
    x1 = np.concatenate([xy[:, :2], np.ones((len(xy), 1))], 1)
    x2 = np.concatenate([xy[:, 2:], np.ones((len(xy), 1))], 1)
    l2 = x1 @ F.T                                   # F x1, lines in image 2
    l1 = x2 @ F                                     # F^T x2, lines in image 1
    num = np.abs((x2 * l2).sum(1))
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.maximum(num / np.hypot(l2[:, 0], l2[:, 1]),
                          num / np.hypot(l1[:, 0], l1[:, 1]))


def f_gap_px(prog: Dict, ref: Dict) -> float:
    """How far the program's F lies from the reference's, in px, on the
    reference's final inliers: the median over them of the gap between a
    correspondence's symmetric epipolar distance under the program's F and
    under the reference's (the distances alone read the inliers' own
    residual, ~0.1 px, where the two F are equal).  0 where neither side
    verifies anything; inf where one side alone does, or where an F is
    not finite."""
    if prog["inliers"] == 0 and ref["inliers"] == 0:
        return 0.0
    Fp, Fr, xy = prog["H"], ref["H"], ref["inlier_xy"]
    if prog["inliers"] == 0 or ref["inliers"] == 0 \
            or not (np.all(np.isfinite(Fp)) and np.all(np.isfinite(Fr))):
        return float("inf")
    gap = np.abs(epipolar_px(Fp, xy) - epipolar_px(Fr, xy))
    return float(np.median(np.where(np.isfinite(gap), gap, np.inf)))


def numbers(prog: Dict, ref: Dict, H_true: np.ndarray, h: int, w: int,
            ver_type: str = "LORANSAC") -> Dict[str, float]:
    """Every candidate number, program against reference (0 = the same):

    steps          |steps the loop ran - the reference's|
    regions        largest relative gap of the regions of an image, any step
    descriptors    the same for the descriptors
    tentatives     largest relative gap of the tentatives or the unique
                   tentatives, any step
    inliers        largest relative gap of the inliers, any step
    H_gap_px       corner distance between the program's H and the
                   reference's (of the last step)
    H_true_px      corner error of the program's H against the generator's
                   true H
    rows_unmatched share of descriptor rows, of both sides, with no row of
                   the other side at the same keypoint: the same position
                   and affine frame in the image within ROW_TOL
    rows_changed   share of the keypoints of either side whose descriptor
                   row is missing on the other side (no row there at the
                   same keypoint) or differs from it by more than 0.5 (a
                   quantization step) in some entry: a matched pair counts
                   once, an unmatched row of either side once
    rows_touched   the same for a difference of more than 2e-3
    F_gap_px       (ver_type LORANSACF only) median gap, over the
                   reference's final inliers, between their symmetric
                   epipolar distances under the program's F and under the
                   reference's (`f_gap_px`)

    Under LORANSACF, H_gap_px and H_true_px treat F as a homography and
    judge nothing."""
    from scipy.spatial import cKDTree
    n = {}
    n["steps"] = float(abs(prog["steps"] - ref["steps"]))
    ps, rs = prog["per_step"], ref["per_step"]
    k = min(len(ps), len(rs))

    def worst(keys):
        vals = [_rel(ps[i][key], rs[i][key]) for i in range(k) for key in keys]
        return max(vals) if vals else (0.0 if len(ps) == len(rs) else 1.0)

    n["regions"] = worst(("regions1", "regions2"))
    n["descriptors"] = worst(("descriptors1", "descriptors2"))
    n["tentatives"] = worst(("tentatives", "unique_tentatives"))
    n["inliers"] = worst(("inliers",))
    n["H_gap_px"] = corner_error(prog["H"], ref["H"], h, w) if ref["H"] is not None else 0.0
    n["H_true_px"] = corner_error(prog["H"], H_true, h, w)
    rows = unmatched = matched = changed = touched = 0
    for sp, sr in zip(prog["images"], ref["images"]):
        kp, dp = _rows(sp)
        kr, dr = _rows(sr)
        rows += len(kp) + len(kr)
        if not len(kp) or not len(kr):
            unmatched += len(kp) + len(kr)
            continue
        dist, j = cKDTree(kr).query(kp, k=1, distance_upper_bound=ROW_TOL)
        hit = np.isfinite(dist)
        back = np.isfinite(cKDTree(kp).query(kr, k=1, distance_upper_bound=ROW_TOL)[0])
        unmatched += int((~hit).sum()) + int((~back).sum())
        matched += int(hit.sum())
        if hit.any():
            e = np.abs(dp[hit] - dr[j[hit]]).max(axis=1)
            changed += int((e > 0.5).sum())
            touched += int((e > 2e-3).sum())
    n["rows_unmatched"] = unmatched / max(rows, 1)
    keys = matched + unmatched
    n["rows_changed"] = (changed + unmatched) / max(keys, 1)
    n["rows_touched"] = (touched + unmatched) / max(keys, 1)
    if ver_type == "LORANSACF":
        n["F_gap_px"] = f_gap_px(prog, ref)
    return n


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List]:
    """(correct, [[name, value, limit], ...]) over the numbers that the
    cell's limits name; a number that is not finite fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        v = float(nums[name])
        good = bool(np.isfinite(v) and v <= lim)
        ok = ok and good
        rows.append([name, v, float(lim)])
    return ok, rows
