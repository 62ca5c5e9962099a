"""Extract the features of an image pair with the port's pipeline and save
them in the reference's native hierarchical format (io/keys.py
save_regions_native), and in its extended format (save_regions_native_ext,
to OUT's stem + "_ext"), which the reference's `mods` binary reads in its
read_pre_extracted mode: extraction parity apart from matcher parity.

    python -m mods_tpu_torch.tools.export_native OUT1 OUT2 --img1 IMG1
        --img2 IMG2 [--config config.ini] [--iters iters.ini]
        [--device cuda|cpu]

Each image goes through the first step of the schedule
(twoview._extract_image; without INIs Config() and one Hessian-Affine
RootSIFT step, tools/common.py); one line per image gives the rows saved
per detector and descriptor.  --device defaults to the CUDA card; without
one only --device cpu runs.
"""
from __future__ import annotations

import argparse
import os
import sys

from .. import full_float32, resolve_device
from ..io import keys
from ..ops.image import as_image
from ..pipeline import TimeLog
from ..twoview import ImageRepresentation, _extract_image
from . import common


def ext_path(out: str) -> str:
    """Where the extended format of OUT goes: a.txt -> a_ext.txt."""
    stem, ext = os.path.splitext(out)
    return stem + "_ext" + ext


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out1")
    ap.add_argument("out2")
    common.add_inputs(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = common.tool_config(args)
    img1, img2 = common.load_pair(args)
    tl = TimeLog()
    for img, out in ((img1, args.out1), (img2, args.out2)):
        rep = ImageRepresentation()
        with full_float32():
            _extract_image(as_image(img, dev), cfg, cfg.iters[0], {}, rep, tl)
        store = {det: {dn: fl[0] for dn, fl in dmap.items()}
                 for det, dmap in rep.store.items()}
        keys.save_regions_native(out, store)
        keys.save_regions_native_ext(ext_path(out), store)
        print(f"{out}: " + ", ".join(
            f"{det}/{dn}={int(f.count())}"
            for det, dmap in store.items() for dn, f in dmap.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
