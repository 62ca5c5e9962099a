"""detect_us_per_region: the program's TimeLog.DetectTime over the regions
its detectors stored, in microseconds a region: the sum over the traced
window's pairs of DetectTime's host seconds (timed to a device
synchronize when traced) over the sum of the counters
`detect.regions.<detector>` (each detector's valid regions added to an
image's store, both images, every step; `per_step[i]["trace"]`,
mods_tpu_torch/timelog.py).  A detection that gets faster by finding
fewer regions does not read lower.  Layer: detection (detect/).  Nothing
to read where a step has no trace or no region was counted (a program
without the counters)."""
NAME = "detect_us_per_region"
UNIT = "us/region"
SOURCE = "program_counter"
PREFIX = "detect.regions."


def read(record):
    pairs = record["pairs"]
    regions = 0
    for p in pairs:
        for step in p["per_step"]:
            tr = step.get("trace")
            if tr is None:
                return None
            regions += sum(n for k, n in tr["counts"].items() if k.startswith(PREFIX))
    seconds = sum(p["timelog"]["DetectTime"] for p in pairs)
    return seconds * 1e6 / regions if regions > 0 and seconds > 0 else None
