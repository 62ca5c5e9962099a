"""The configuration file -> a `Config` of the program or of the reference.

Both packages have the same `config` module (the reference's is a frozen
copy), so one function builds either from the same file: the program and
the reference run the same settings.

`Config()` gives `dog` and `harris` the Hessian response; the program's
INI loader types them from their sections.  Here a schedule that names
`DoG` or `HarrisAffine` types that detector, as those sections do: its
response, and the threshold rule of the localizer, follow the type."""
from __future__ import annotations

from typing import Dict

from .spec import ROOT

# the detector_type that the program's INI loader gives a schedule name
TYPED = {"DoG": ("dog", "DoG"), "HarrisAffine": ("harris", "Harris")}


def build_config(cfgmod, spec: Dict):
    """cfgmod: the `config` module of the program or of the reference."""
    cfg = cfgmod.Config()
    cfg.max_keypoints = int(spec["max_keypoints"])
    cfg.max_octave_cands = int(spec["max_octave_cands"])
    cfg.matching.minMatches = int(spec["min_matches"])
    cfg.matching.knn = int(spec["knn"])
    desc = spec["descriptor"]
    steps = []
    for st in spec["schedule"]:
        step = cfgmod.detector_step(st["detectors"], [float(t) for t in st["tilts"]],
                                    float(st["phi"]), desc)
        for det in st["detectors"]:
            step.detectors[det]["fginn"][desc] = float(spec["fginn"])
            if det in TYPED:
                field, kind = TYPED[det]
                getattr(cfg, field).pyramid.detector_type = kind
        steps.append(step)
    cfg.iters = steps
    if spec.get("weights"):
        cfg.hardnet.weights = str(ROOT / spec["weights"])
    return cfg
