"""extrema_ms: device ms of the program's span DetectTime.extrema a pair
(each octave's extrema search, localization and duplicate map), the mean
over the traced window's pairs of its sum over the pair's steps, read as
pyramid_ms reads its span.  Layer: detection (detect/)."""
from pbcore import spec

NAME = "extrema_ms"
UNIT = "ms"
SOURCE = "program_span"


def read(record):
    return spec.metric("pyramid_ms").span_device_ms(record, "DetectTime.extrema")
