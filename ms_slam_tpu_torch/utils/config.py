"""YAML settings parsing.

Port of `ms_slam_tpu/utils/config.py`: `Settings` reads a settings file of
the reference's two schema generations (legacy flat keys such as
`Camera.fx`, and the File.version "1.0" sections such as `Camera1.fx`) into
one flat key space and builds the port's `Calib`, `OrbConfig`, `MapConfig`
and `SystemConfig` from it exactly as the reference builds its own. Unknown
keys are ignored; a missing required key raises with the key's name.

The reference parses with PyYAML. The port has its own reader,
`load_opencv_yaml`, for the OpenCV-YAML subset that settings files use, so
that it needs no package beyond numpy: the `%YAML:1.0` directive and `---`,
comments, `Key.Sub: value` lines, quoted strings, flow lists (which may
span lines), and nested blocks such as an `!!opencv-matrix` with its
`rows` / `cols` / `dt` / `data` keys (flattened as `Stereo.T_c1_c2.data`).
Plain scalars resolve to the types PyYAML's YAML 1.1 rules give them (so
`1e-3`, with no dot, stays a string). Anything outside the subset raises.
"""
from __future__ import annotations

import math
import re
from typing import Any

import numpy as np

from ..models.map_state import MapConfig
from ..ops import cameras
from ..ops.orb import OrbConfig
from ..pipeline.frontend import Calib
from ..pipeline.system import SystemConfig

# PyYAML's implicit resolvers for YAML 1.1 plain scalars (yaml/resolver.py)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")


def _sexagesimal(sign: int, digits: str, cast):
    value = cast(0)
    base = 1
    for part in reversed(digits.split(":")):
        value += cast(part) * base
        base *= 60
    return sign * value


def _to_int(text: str) -> int:
    """PyYAML's construct_yaml_int."""
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return _sexagesimal(sign, v, int)
    return sign * int(v)


def _to_float(text: str) -> float:
    """PyYAML's construct_yaml_float."""
    v = text.replace("_", "").lower()
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return _sexagesimal(sign, v, float)
    return sign * float(v)


def _unquote(text: str, where: str) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"{where}: unterminated string {text!r}")
    body = text[1:-1]
    if q == "'":
        return body.replace("''", "'")
    escapes = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t",
               "r": "\r", "0": "\0"}
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == "\\":
            if i + 1 >= len(body) or body[i + 1] not in escapes:
                raise ValueError(f"{where}: unsupported escape in {text!r}")
            out.append(escapes[body[i + 1]])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _scalar(text: str, where: str):
    if text[:1] in ("'", '"'):
        return _unquote(text, where)
    if text[:1] in tuple("[{!&*|>") or text == "-" or text.startswith("- "):
        raise ValueError(f"{where}: {text!r} is outside the supported "
                         "subset of YAML")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _to_float(text)
    if _INT.match(text):
        return _to_int(text)
    return text


def _split_outside_quotes(text: str, seps: str):
    """Yield (index, char) of each character of `seps` in `text` that lies
    outside a quoted string; a quote opens a string only where a scalar
    starts (after nothing, a space, ':', '[' or ',')."""
    q = None
    i = 0
    while i < len(text):
        c = text[i]
        if q is not None:
            if q == '"' and c == "\\":
                i += 1
            elif c == q:
                if q == "'" and text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    q = None
        elif c in ("'", '"') and (i == 0 or text[i - 1] in " \t:[,"):
            q = c
        elif c in seps:
            yield i, c
        i += 1


def _strip_comment(line: str) -> str:
    for i, _ in _split_outside_quotes(line, "#"):
        if i == 0 or line[i - 1] in " \t":
            return line[:i]
    return line


def _flow_list(text: str, where: str) -> list:
    if not text.endswith("]"):
        raise ValueError(f"{where}: text after a flow list: {text!r}")
    inner = text[1:-1]
    items, start = [], 0
    for i, c in _split_outside_quotes(inner, ",[]{}"):
        if c != ",":
            raise ValueError(f"{where}: nested flow collections are outside "
                             "the supported subset of YAML")
        items.append(inner[start:i].strip())
        start = i + 1
    items.append(inner[start:].strip())
    if items == [""]:
        return []
    if items[-1] == "":
        items.pop()                     # a trailing comma
    if "" in items:
        raise ValueError(f"{where}: empty item in a flow list")
    return [_scalar(s, where) for s in items]


def _bracket_depth(text: str) -> int:
    depth = 0
    for _, c in _split_outside_quotes(text, "[]"):
        depth += 1 if c == "[" else -1
    return depth


def _block(lines, pos: int, indent: int, path: str):
    """Parse the block mapping whose keys sit at `indent`, from lines[pos];
    returns (dict, next position)."""
    out: dict = {}
    while pos < len(lines):
        ln, ind, text = lines[pos]
        where = f"{path}:{ln}"
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"{where}: unexpected indentation")
        colon = next((i for i, _ in _split_outside_quotes(text, ":")
                      if text[i + 1:i + 2] in ("", " ", "\t")), None)
        if colon is None or colon == 0:
            raise ValueError(f"{where}: expected 'key: value', got {text!r}")
        key = _scalar(text[:colon].strip(), where)
        rest = text[colon + 1:].strip()
        pos += 1
        if rest.startswith("!!"):
            tag, _, rest = rest.partition(" ")
            if tag != "!!opencv-matrix":
                raise ValueError(f"{where}: unsupported tag {tag}")
            rest = rest.strip()
        if rest == "":
            if pos < len(lines) and lines[pos][1] > indent:
                value, pos = _block(lines, pos, lines[pos][1], path)
            else:
                value = None
        elif rest.startswith("["):
            while _bracket_depth(rest) > 0:
                if pos >= len(lines):
                    raise ValueError(f"{where}: unterminated flow list")
                rest += " " + lines[pos][2]
                pos += 1
            value = _flow_list(rest, where)
        else:
            value = _scalar(rest, where)
        out[key] = value
    return out, pos


def load_opencv_yaml(path: str) -> dict:
    """The mapping of an OpenCV-style settings file, as PyYAML's safe_load
    gives it after the reference drops the `%YAML` line and the
    `!!opencv-matrix` tag."""
    with open(path) as f:
        text = f.read()
    if text.startswith("%YAML"):
        text = text.split("\n", 1)[1] if "\n" in text else ""
    lines = []
    for n, raw in enumerate(text.split("\n"), start=1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line in ("---", "..."):
            if lines:
                raise ValueError(f"{path}:{n}: one document per file")
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"{path}:{n}: tab in indentation")
        lines.append((n, len(line) - len(line.lstrip()), line.strip()))
    if not lines:
        return {}
    out, pos = _block(lines, 0, lines[0][1], path)
    if pos != len(lines):
        raise ValueError(f"{path}:{lines[pos][0]}: unexpected indentation")
    return out


class Settings:
    """Typed reader over the flattened key space."""

    def __init__(self, path: str):
        self.raw = load_opencv_yaml(path)
        self.flat: dict[str, Any] = {}
        self._flatten("", self.raw)

    def _flatten(self, prefix: str, node):
        if isinstance(node, dict):
            for k, v in node.items():
                key = f"{prefix}.{k}" if prefix else str(k)
                self._flatten(key, v)
        else:
            self.flat[prefix] = node

    def get(self, *names, default=None, required=False):
        for n in names:
            if n in self.flat and self.flat[n] is not None:
                return self.flat[n]
        if required:
            raise KeyError(f"missing required setting (any of): {names}")
        return default

    # ------------------------------------------------------------------

    def calib(self) -> Calib:
        g = self.get
        cam_type = str(g("Camera.type", "Camera1.type", default="PinHole"))
        fx = float(g("Camera.fx", "Camera1.fx", required=True))
        fy = float(g("Camera.fy", "Camera1.fy", required=True))
        cx = float(g("Camera.cx", "Camera1.cx", required=True))
        cy = float(g("Camera.cy", "Camera1.cy", required=True))
        if cam_type.lower() in ("kannalabrandt8", "fisheye"):
            params = (fx, fy, cx, cy,
                      float(g("Camera.k1", "Camera1.k1", default=0.0)),
                      float(g("Camera.k2", "Camera1.k2", default=0.0)),
                      float(g("Camera.k3", "Camera1.k3", default=0.0)),
                      float(g("Camera.k4", "Camera1.k4", default=0.0)))
            model = cameras.KB8
        else:
            params = (fx, fy, cx, cy)
            model = cameras.PINHOLE
        width = int(g("Camera.width", "Camera.cols", default=0) or 0)
        height = int(g("Camera.height", "Camera.rows", default=0) or 0)
        bf = float(g("Camera.bf", "Stereo.b", default=0.0) or 0.0)
        if "Stereo.b" in self.flat and "Camera.bf" not in self.flat:
            bf = float(self.flat["Stereo.b"]) * fx
        th_depth = float(g("ThDepth", "Camera.ThDepth", "Stereo.ThDepth",
                           default=35.0))
        fps = float(g("Camera.fps", default=10.0) or 10.0)
        # stereo-fisheye second camera (ref Settings::readCamera2 +
        # Stereo.T_c1_c2 + Camera1/2.overlappingBegin/End): two unrectified
        # KB8 cameras
        params2: tuple = ()
        T_rl: tuple = ()
        lapping: tuple = ()
        if model == cameras.KB8 and "Camera2.fx" in self.flat:
            params2 = (float(g("Camera2.fx")), float(g("Camera2.fy")),
                       float(g("Camera2.cx")), float(g("Camera2.cy")),
                       float(g("Camera2.k1", default=0.0)),
                       float(g("Camera2.k2", default=0.0)),
                       float(g("Camera2.k3", default=0.0)),
                       float(g("Camera2.k4", default=0.0)))
            T12 = np.asarray(g("Stereo.T_c1_c2.data",
                               "Stereo.T_c1_c2", required=True),
                             np.float64).reshape(-1)[:16].reshape(4, 4)
            # T_c1_c2 maps cam2 coordinates into cam1 coordinates; the
            # frontend wants right-from-left, its inverse
            T21 = np.linalg.inv(T12)
            T_rl = tuple(float(v) for v in T21[:3, :4].reshape(-1))
            lapping = (int(g("Camera1.overlappingBegin", default=0)),
                       int(g("Camera1.overlappingEnd",
                             default=width or 10 ** 6)),
                       int(g("Camera2.overlappingBegin", default=0)),
                       int(g("Camera2.overlappingEnd",
                             default=width or 10 ** 6)))
            if bf <= 0:
                bf = float(np.linalg.norm(T12[:3, 3])) * fx
        # ThDepth is in units of baseline (ref: mThDepth = mbf*ThDepth/fx),
        # after a KB8 pair's bf has come from its T_c1_c2
        th_depth_m = bf * th_depth / fx if bf > 0 else 1e9
        return Calib(model=model, params=params, bf=bf, width=width,
                     height=height, th_depth=th_depth_m, fps=fps,
                     params2=params2, T_rl=T_rl, lapping=lapping)

    def orb(self, n_feat_cap: int | None = None) -> OrbConfig:
        g = self.get
        n = int(g("ORBextractor.nFeatures", default=2000))
        if n_feat_cap:
            n = min(n, n_feat_cap)
        # rounded up to a multiple of 128, as the reference does
        n = -(-n // 128) * 128
        return OrbConfig(
            n_features=n,
            n_levels=int(g("ORBextractor.nLevels", default=8)),
            scale_factor=float(g("ORBextractor.scaleFactor", default=1.2)),
            ini_th=float(g("ORBextractor.iniThFAST", default=20)),
            min_th=float(g("ORBextractor.minThFAST", default=7)),
        )

    def system_config(self, max_kf: int = 512, max_mp: int = 65536,
                      local_cap: int = 8192) -> SystemConfig:
        g = self.get
        calib = self.calib()
        orb = self.orb()
        mcfg = MapConfig(max_kf=max_kf, max_mp=max_mp,
                         n_feat=orb.n_features, local_mp_cap=local_cap,
                         window_kf=8)
        # IMU block (ref Settings::readIMU; the noise keys mark an inertial
        # configuration)
        has_imu = g("IMU.NoiseGyro") is not None
        Tbc = g("IMU.T_b_c1", "IMU.T_b_c1.data", "Tbc", "Tbc.data")
        if Tbc is not None:
            Tbc = np.asarray(Tbc, np.float64).reshape(4, 4)
        return SystemConfig(
            calib=calib, orb=orb, map=mcfg,
            max_frames_between_kf=int(round(calib.fps)),
            sparsify=g("Sparsification.N") is not None,
            sparsify_n=int(g("Sparsification.N", default=75)),
            sparsify_lambda=float(g("Sparsification.Lambda", default=500)),
            sparsify_grid_lambda=float(
                g("Sparsification.GridLambda", default=10)),
            sparsify_window=int(g("Sparsification.WindowLength", default=30)),
            nonlocal_kf=int(g("Sparsification.NonLocalKF", default=30)),
            loop_closing=bool(int(g("loopClosing", default=1))),
            use_imu=has_imu,
            imu_noise_gyro=float(g("IMU.NoiseGyro", default=1e-3)),
            imu_noise_acc=float(g("IMU.NoiseAcc", default=1e-2)),
            imu_gyro_walk=float(g("IMU.GyroWalk", default=1e-6)),
            imu_acc_walk=float(g("IMU.AccWalk", default=1e-4)),
            Tbc=Tbc,
        )
