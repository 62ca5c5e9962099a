"""extrema_kernel_share: the share of the octaves whose extrema search,
localization and duplicate map ran as the port's CUDA kernels, in %: 100
* the sum of the program's counter detect.octaves.kernel over the sum of
detect.octaves (every octave of every scale-space detection), over the
traced window's pairs and their steps (`per_step[i]["trace"]`,
mods_tpu_torch/timelog.py).  On the card it should read 100: less means a
path that bypasses the kernels (ops/octave_extrema.py).  Layer: detection
(detect/).  Read from a window traced on the card (one with a device
trace), as knn_valid_share: a rehearsal on the CPU takes the plain chain
by design.  Nothing to read where a step has no trace (a program without
the tracer) or no octave was counted (a program without the counters)."""
NAME = "extrema_kernel_share"
UNIT = "%"
SOURCE = "program_counter"


def read(record):
    if not record["trace"]:
        return None
    kernel = octaves = 0
    for p in record["pairs"]:
        for step in p["per_step"]:
            tr = step.get("trace")
            if tr is None:
                return None
            kernel += tr["counts"].get("detect.octaves.kernel", 0)
            octaves += tr["counts"].get("detect.octaves", 0)
    return 100.0 * kernel / octaves if octaves > 0 else None
