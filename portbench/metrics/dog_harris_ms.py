"""dog_harris_ms: host ms of the program's spans Detector.DoG and
Detector.HarrisAffine a pair (each detector's whole extraction of an
image: synthesis, detection, orientation and description of its views),
the mean over the traced window's pairs of their sum over the pair's
steps, read as mser_ms reads its span.  Traced, the phases inside these
spans end in a device synchronize, so their host time holds the device's
work.  Layer: detection (detect/, synth/atlas.py)."""
from pbcore import spec

NAME = "dog_harris_ms"
UNIT = "ms"
SOURCE = "program_span"


def read(record):
    return spec.metric("mser_ms").span_host_ms(
        record, ("Detector.DoG", "Detector.HarrisAffine"))
