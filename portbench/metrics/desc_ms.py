"""desc_ms: host ms of the program's TimeLog.DescTime a pair, the mean over the
traced window's pairs (TimeLog times each phase after a device
synchronize).  Layer: description (desc/sift.py, desc/cnn.py).  Nothing to read where no pair spent time
there."""
NAME = "desc_ms"
UNIT = "ms"
SOURCE = "program_span"


def read(record):
    pairs = record["pairs"]
    total = sum(p["timelog"]["DescTime"] for p in pairs)
    return total * 1e3 / len(pairs) if pairs and total > 0 else None
