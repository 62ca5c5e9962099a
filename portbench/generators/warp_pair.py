"""Traffic generator: a mild perspective warp of a textured scene.

params: h, w (see pbcore.pairs.warp_pair)."""
from pbcore.pairs import warp_pair


def make(params, seed):
    return warp_pair(int(params["h"]), int(params["w"]), seed)
