"""knn_valid_share: the share of the kNN's distance cells that lie between
valid descriptor rows, in %: 100 * the sum of the program's counter
knn.valid_cells (valid rows x valid columns of each kNN call) over the
sum of knn.cells (all rows x columns the calls compute), over the traced
window's pairs and their steps (`per_step[i]["trace"]`,
mods_tpu_torch/timelog.py).  The rest is padding.  Layer: matching
(match/matching.py).  Read from a window traced on the card (one with a
device trace), as pyramid_ms and extrema_ms, whose spans hold device time
there alone: a rehearsal on the CPU reports the phase spans only.  Nothing
to read where a step has no trace (a program without the tracer) or no
call computed a cell."""
NAME = "knn_valid_share"
UNIT = "%"
SOURCE = "program_counter"


def read(record):
    if not record["trace"]:
        return None
    valid = cells = 0
    for p in record["pairs"]:
        for step in p["per_step"]:
            tr = step.get("trace")
            if tr is None:
                return None
            valid += tr["counts"].get("knn.valid_cells", 0)
            cells += tr["counts"].get("knn.cells", 0)
    return 100.0 * valid / cells if cells > 0 else None
