"""Neither the runner nor the reference loads JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""
import subprocess
import sys
from pathlib import Path

PB = Path(__file__).resolve().parents[1]

PROBE = r"""
import sys
sys.path[:0] = [{root!r}, {pb!r}]
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def _tops(body: str):
    code = PROBE.format(root=str(PB.parent), pb=str(PB), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_runner_loads_no_jax():
    tops = _tops("import run\nfrom pbcore import compare, trace, roofline, draws, spec\n"
                 "import mods_tpu_torch.twoview, reference\nfrom reference.mods import twoview\n"
                 "for m in [w['name'] for w in spec.load_benchmark()['per_layer']]:\n"
                 "    spec.metric(m)\n"
                 "spec.generator('tilted_pair'); spec.generator('warp_pair')")
    assert "mods_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "mods_tpu"}


def test_reference_loads_nothing_of_the_port():
    body = ("import numpy as np, torch\nimport reference\nfrom pbcore import spec, pairs\n"
            "from pbcore.draws import PairDraws\n"
            "s = spec.config(spec.load_benchmark(), 'hessaff-rootsift')\n"
            "s.update(max_keypoints=256, max_octave_cands=256, schedule=s['schedule'][:1])\n"
            "i1, i2, H = pairs.warp_pair(96, 128, 1)\n"
            "r = reference.match_pair(i1, i2, s, PairDraws(1, 0, 'cpu'), 'cpu')\n"
            "assert r.steps_done == 1")
    tops = _tops(body)
    assert "reference" in tops
    assert not tops & {"mods_tpu_torch", "jax", "jaxlib", "flax", "mods_tpu"}


def test_reference_sources_name_no_program_module():
    for f in (PB / "reference").rglob("*.py"):
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "mods_tpu" not in s, f"{f}: {s}"
