"""knn_roofline: the kNN's least time over the device work under the
program's MatchTime spans, in %.

The least time counts the work and not the rows that hold it: each step
of each pair matches the valid descriptors of image 1 (N1, the step's
`descriptors1`) against image 2's (N2): 2 N1 N2 D operations, and bytes
of the valid descriptors read once plus the k-NN lists written
(pbcore.roofline).  Removing padded rows therefore shows as a gain.  The
configurations this reads match one descriptor of one detector a step, so
a step's descriptor counts are its matching call's rows."""
from pbcore import roofline

NAME = "knn_roofline"
UNIT = "%"
SOURCE = "device_trace"


def least_s(pairs, dim: int, k: int) -> float:
    return sum(roofline.least_seconds(roofline.knn_ops(s["descriptors1"], s["descriptors2"], dim),
                                      roofline.knn_bytes(s["descriptors1"], s["descriptors2"], dim, k))
               for p in pairs for s in p["per_step"])


def read(record):
    tr = record["trace"]
    dev = tr and tr["span_device_s"].get("MatchTime")
    if not dev:
        return None
    spec = record["spec"]
    least = least_s(record["pairs"], int(spec["dims"]), int(spec["knn"]))
    return 100.0 * least / dev if least > 0 else None
