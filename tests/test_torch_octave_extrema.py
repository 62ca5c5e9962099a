"""ops/octave_extrema.py on the CPU: the wrapper takes its plain version,
which is find_extrema -> localize -> dedup_octave_map unchanged.

- For Hessian under FixedTh and RelativeTh, DoG, iiDoG on a view with
  black corners (NaN responses), Harris, and a cap below the extrema
  count, the wrapper returns, field for field, what the three functions
  called in turn return, and launches nothing.
- A tensor neither on the CPU nor on a CUDA device raises.
The kernels themselves are held to the plain version on the card
(chip_smoke.py, phase 1b)."""
import dataclasses

import pytest
import torch

from mods_tpu_torch.detect import detector as det
from mods_tpu_torch.detect import pyramid as pyr
from mods_tpu_torch.ops import octave_extrema as ox
from mods_tpu_torch.ops import patch_kernels as pk
from mods_tpu_torch.testing import mods_detectors_config, textured_image, tilted_pair


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(case):
    cfg = mods_detectors_config()
    if case.startswith("hessian"):
        par = cfg.hessian.pyramid
    elif case == "harris":
        par = cfg.harris.pyramid
    else:
        par = dataclasses.replace(cfg.dog.pyramid, iiDoGMode=case == "iidog")
    if case in ("hessian_relative", "hessian_cap"):
        par = dataclasses.replace(par, detector_mode="RelativeTh")
    return par


CASES = {
    # case: (image, cap)
    "hessian_fixed": ("textured", 4096),
    "hessian_relative": ("textured", 4096),
    "dog": ("black_corners", 4096),
    "iidog": ("black_corners", 4096),
    "harris": ("textured", 4096),
    "hessian_cap": ("textured", 64),
}


def _octave(case):
    image, cap = CASES[case]
    img = (textured_image(96, 128, 31) if image == "textured"
           else tilted_pair(96, 128, 12, 2.0, 0.3)[1])
    par = _params(case)
    first = det._first_level(torch.from_numpy(img), par)
    _, resp, sigmas, _ = pyr.build_octave(first, par, par.initialSigma)
    return resp, par, cap, sigmas


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_wrapper_is_the_plain_chain(case):
    resp, par, cap, sigmas = _octave(case)
    if case == "iidog":
        assert torch.isnan(resp).any()
    lev, r0, c0, cand_valid, n_ext = pyr.find_extrema(resp, par, cap)
    okp, r, c = pyr.localize(resp, None, lev, r0, c0, cand_valid, par, sigmas)
    kept = pyr.dedup_octave_map(r, c, okp.valid, resp.shape[-1])
    pk.reset_launches()
    got_okp, got_r, got_c, got_kept, got_n = ox.octave_extrema(resp, par, cap, sigmas)
    assert all(v == 0 for v in pk.LAUNCHES.values())
    assert got_n == n_ext and isinstance(got_n, int)
    if case == "hessian_cap":
        assert n_ext > cap == got_r.shape[0]
    else:
        assert 0 < n_ext < cap
    for a, b in ((got_r, r), (got_c, c), (got_kept, kept), *zip(got_okp, okp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(kept.sum()) > 0


def test_refuses_a_device_other_than_cpu_or_cuda():
    resp, par, cap, sigmas = _octave("hessian_fixed")
    with pytest.raises(ValueError):
        ox.octave_extrema(resp.to("meta"), par, cap, sigmas)
