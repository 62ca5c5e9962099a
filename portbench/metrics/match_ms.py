"""match_ms: host ms of the program's TimeLog.MatchTime a pair, the mean over the
traced window's pairs (TimeLog times each phase after a device
synchronize).  Layer: matching (match/matching.py).  Nothing to read where no pair spent time
there."""
NAME = "match_ms"
UNIT = "ms"
SOURCE = "program_span"


def read(record):
    pairs = record["pairs"]
    total = sum(p["timelog"]["MatchTime"] for p in pairs)
    return total * 1e3 / len(pairs) if pairs and total > 0 else None
