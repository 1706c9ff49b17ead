"""The port's settings reader (`utils/config.py`) against the reference's.

- On every file of `configs/`: `Settings.flat` equal key by key, value by
  value and type by type (the port's own OpenCV-YAML reader against the
  reference's PyYAML); `calib()`, `orb()` and `system_config()` equal field
  by field, `Tbc` included (exact: the same arithmetic on the same floats).
- The reader against PyYAML on constructs of the subset the configs do not
  all use: YAML 1.1 scalar types (`1e-3` with no dot stays a string),
  quoting, comments, multi-line flow lists, an `!!opencv-matrix` block.
- The port needs no PyYAML: a subprocess with `sys.modules["yaml"] = None`
  reads every file.
"""
import dataclasses
import glob
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ms_slam_tpu.utils.config import Settings as JSettings
from ms_slam_tpu.utils.config import _load_yaml
from ms_slam_tpu_torch.utils.config import Settings, load_opencv_yaml

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _same(a, b):
    """Equal in value and in type, recursively; NaN equals NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _fields(x):
    """A config object as a dict of its fields (NamedTuple or dataclass)."""
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return x._asdict()


def test_all_seven_configs_are_covered():
    assert len(CONFIGS) == 7, CONFIGS


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_flat_equals_reference(path):
    ref, got = JSettings(path).flat, Settings(path).flat
    assert list(got) == list(ref)
    bad = {k: (ref[k], got[k]) for k in ref if not _same(ref[k], got[k])}
    assert not bad


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_built_configs_equal_reference(path):
    js, ts = JSettings(path), Settings(path)
    assert _same(_fields(ts.calib()), _fields(js.calib()))
    assert _same(_fields(ts.orb()), _fields(js.orb()))
    assert _same(_fields(ts.orb(n_feat_cap=1000)),
                 _fields(js.orb(n_feat_cap=1000)))
    tc, jc = ts.system_config(), js.system_config()
    assert _same(_fields(ts.system_config(64, 4096, 1024).map),
                 _fields(js.system_config(64, 4096, 1024).map))
    tf, jf = _fields(tc), _fields(jc)
    # the two SystemConfigs have the same fields, each compared below
    assert set(jf) == set(tf)
    for name in tf:
        a, b = tf[name], jf[name]
        if name in ("calib", "orb", "map"):
            a, b = _fields(a), _fields(b)
        assert _same(a, b), (name, a, b)
    if "Inertial" in path or "4season" in path:
        assert tc.use_imu and tc.Tbc.shape == (4, 4)


TRICKY = """%YAML:1.0
---
# a comment line
A: 1e-3
B: 1.0e-3
C: 0x1F
D: 017
E: 1_000
F: 1:30
G: .inf
H: -.Inf
I: yes
J: Off
K: ~
L:
M: "quoted # not a comment"
N: 'it''s'   # trailing comment
O: [ 1, 2.5, "x, y", 'z' ,
     -3, 1e5, true ]
P: !!opencv-matrix
   rows: 2
   cols: 2
   dt: d
   data: [1.0, 2.0,
          3.0, 4.0]
Q: plain text with spaces
R: []
S: "esc \\"q\\" \\\\ done"
T: 0
U: -0.5
V: +12
W: 12.
X: 0b101
Y: [a, b, ]
Z: null
Camera.fx: 435.2046959714599
"""


def test_reader_matches_pyyaml_on_the_subset(tmp_path):
    p = tmp_path / "tricky.yaml"
    p.write_text(TRICKY)
    ref = _load_yaml(str(p))
    got = load_opencv_yaml(str(p))
    assert _same(got, ref)
    assert got["A"] == "1e-3" and got["B"] == 1e-3
    assert _same(Settings(str(p)).flat, JSettings(str(p)).flat)
    assert Settings(str(p)).flat["P.data"] == [1.0, 2.0, 3.0, 4.0]


@pytest.mark.parametrize("text", [
    "A:\n  - 1\n  - 2\n",            # block sequence
    "A: {x: 1}\n",                    # flow mapping
    "A: [1, [2, 3]]\n",               # nested flow list
    "A: 1\n  B: 2\n",                 # a continuation line
    "A: [1, 2\n",                     # unterminated flow list
    "A: !!binary abc\n",              # another tag
    ": 5\n",                          # no key
])
def test_reader_rejects_what_it_does_not_read(tmp_path, text):
    p = tmp_path / "bad.yaml"
    p.write_text(text)
    with pytest.raises(ValueError):
        load_opencv_yaml(str(p))


def test_port_needs_no_pyyaml():
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "import glob\n"
        "from ms_slam_tpu_torch.utils.config import Settings\n"
        "paths = sorted(glob.glob('configs/*.yaml'))\n"
        "for p in paths:\n"
        "    s = Settings(p)\n"
        "    s.system_config()\n"
        "assert 'yaml' not in [m for m, v in sys.modules.items() "
        "if v is not None]\n"
        "print('ok', len(paths))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "7"]
