"""pyramid_ms: device ms of the program's span DetectTime.pyramid a pair
(the scale-space pyramid: each octave's blurs and responses, with the
first level), the mean over the traced window's pairs of its sum over the
pair's steps.  The span's device time is a pair of CUDA events around it
(`per_step[i]["trace"]`, mods_tpu_torch/timelog.py).  Layer: detection
(detect/).  Nothing to read where a step has no trace (a program without
the tracer), where the span has no device time, or where no pair spent
time there."""
NAME = "pyramid_ms"
UNIT = "ms"
SOURCE = "program_span"


def span_device_ms(record, name):
    """The mean over the record's pairs of the span `name`'s device ms,
    summed over each pair's steps; None where there is nothing to read."""
    pairs = record["pairs"]
    total = 0.0
    for p in pairs:
        for step in p["per_step"]:
            tr = step.get("trace")
            if tr is None:
                return None
            span = tr["spans"].get(name)
            if span is not None:
                if span["device_ms"] is None:
                    return None
                total += span["device_ms"]
    return total / len(pairs) if pairs and total > 0 else None


def read(record):
    return span_device_ms(record, "DetectTime.pyramid")
