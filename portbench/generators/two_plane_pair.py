"""Traffic generator: two planes seen by two cameras (a fundamental
matrix fits both, a homography one).

params: h, w (see pbcore.pairs.two_plane_pair).  The third item is the
scene's F, not a homography."""
from pbcore.pairs import two_plane_pair


def make(params, seed):
    return two_plane_pair(int(params["h"]), int(params["w"]), seed)
