"""mser_ms: host ms of the program's span DetectTime.mser a pair (MSER's
host component tree: each view's pixels to the host, the C++ tree through
ctypes, the frames back on the device), the mean over the traced window's
pairs of its sum over the pair's steps (`per_step[i]["trace"]`,
mods_tpu_torch/timelog.py).  Host time, since the tree runs on the host
and the device waits.  Layer: detection (detect/mser.py).  Nothing to read
where a step has no trace, or where no pair spent time there (a program
without the span)."""
NAME = "mser_ms"
UNIT = "ms"
SOURCE = "program_span"


def span_host_ms(record, names):
    """The mean over the record's pairs of the host ms of the spans
    `names`, summed over each pair's steps; None where there is nothing to
    read."""
    pairs = record["pairs"]
    total = 0.0
    for p in pairs:
        for step in p["per_step"]:
            tr = step.get("trace")
            if tr is None:
                return None
            total += sum(tr["spans"][n]["host_ms"] for n in names if n in tr["spans"])
    return total / len(pairs) if pairs and total > 0 else None


def read(record):
    return span_host_ms(record, ("DetectTime.mser",))
