"""Machine-readable run logs (reference io_mods.cpp:10-99 WriteLog /
WriteTimeLog): one whitespace line per verification mode, and the table of
per-phase times.

Counterpart of the JAX package's io/logs.py, over the port's
`twoview.TwoViewResult` and `pipeline.TimeLog`; the text is the same.
"""
from __future__ import annotations

from typing import TextIO


def write_log(res, ver_type: str, total_time: float, out: TextIO) -> None:
    """WriteLog (io_mods.cpp:10-67).  `res` is a TwoViewResult."""
    g = lambda v: f"{v:.3g}"
    if ver_type == "GR_PLUS_RANSAC":
        cols = [g(total_time), res.inliers, res.unique_tentatives,
                g(100.0 * res.inlier_ratio), res.true_matches_gt,
                res.unique_tentatives,
                g(100.0 * res.true_matches_gt / max(res.unique_tentatives, 1)),
                res.regions1, res.regions2, res.steps_done]
    else:   # LORANSAC / LORANSACF / ORSA / GR_TRUTH share the shape
        n_true = res.true_matches_gt if ver_type == "GR_TRUTH" else res.inliers
        cols = [g(total_time), n_true, res.unique_tentatives,
                g(100.0 * res.inlier_ratio), res.regions1, res.regions2,
                res.steps_done]
    out.write(" ".join(str(c) for c in cols) + " \n")


def write_time_log(tl, total_time: float, out: TextIO, write_rel: bool = True,
                   write_abs: bool = True, write_desc: bool = True) -> None:
    """WriteTimeLog (io_mods.cpp:68-99).  `tl` is a TimeLog; MISC is what
    the other phases leave of total_time."""
    misc = max(total_time - (tl.SynthTime + tl.DetectTime + tl.OrientTime
                             + tl.DescTime + tl.MatchTime + tl.RANSACTime), 0.0)
    vals = [tl.SynthTime, tl.DetectTime, tl.OrientTime, tl.DescTime,
            tl.MatchTime, tl.RANSACTime, misc, total_time]
    if write_desc:
        out.write("Timings: (sec/%) \n"
                  "Synth|Detect|Orient|Desc|Match|RANSAC|MISC|Total \n")
    if write_abs:
        out.write(" ".join(f"{v:.3g}" for v in vals) + "\n")
    if write_rel and total_time > 0:
        out.write(" ".join(f"{100.0 * v / total_time:.3g}" for v in vals) + "\n")
