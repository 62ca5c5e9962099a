"""verify_ms: host ms of the program's TimeLog.MiscTime + RANSACTime a
pair (tentatives merged, the duplicate filter, LO-RANSAC), the mean over
the traced window's pairs.  Layer: the loop (twoview.py) and verification
(verify/)."""
NAME = "verify_ms"
UNIT = "ms"
SOURCE = "program_span"


def read(record):
    pairs = record["pairs"]
    total = sum(p["timelog"]["MiscTime"] + p["timelog"]["RANSACTime"] for p in pairs)
    return total * 1e3 / len(pairs) if pairs and total > 0 else None
