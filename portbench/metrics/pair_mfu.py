"""pair_mfu: the pairs' model FLOPs over the traced window's wall time and
the card's float32 peak (67 TFLOP/s, TF32 off as the port runs), in %.

Model FLOPs: the kNN's 2 N1 N2 D over valid rows of every step
(knn_roofline) plus HardNet's convolutions where the configuration runs
HardNet (hardnet_roofline).  The run's `device` line carries the card's
power limit beside it."""
from pbcore import roofline, spec

NAME = "pair_mfu"
UNIT = "%"
SOURCE = "device_trace"


def read(record):
    tr = record["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    s = record["spec"]
    dim = int(s["dims"])
    knn = sum(roofline.knn_ops(st["descriptors1"], st["descriptors2"], dim)
              for p in record["pairs"] for st in p["per_step"])
    total = knn + spec.metric("hardnet_roofline").flops(record)
    return 100.0 * total / tr["window_s"] / roofline.F32_FLOPS if total > 0 else None
