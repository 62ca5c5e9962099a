"""device_idle_share: 100 * (1 - the union of the device's work intervals
/ the traced window's wall time), from the profiler's trace."""
NAME = "device_idle_share"
UNIT = "%"
SOURCE = "device_trace"


def read(record):
    tr = record["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
