"""Traffic generator: a plane seen head-on and from the side.

params: h, w, tilt, psi (see pbcore.pairs.tilted_pair)."""
from pbcore.pairs import tilted_pair


def make(params, seed):
    return tilted_pair(int(params["h"]), int(params["w"]), seed,
                       float(params["tilt"]), float(params["psi"]))
