"""Dataset loaders: KITTI odometry, EuRoC MAV, TUM RGB-D.

Port of `ms_slam_tpu/utils/datasets.py` (numpy, cv2 and the native
runtime; no device code), on the port's own `utils/native.py`. They replace
the reference system's LoadImages routines of its stereo and
stereo-inertial examples, and its precomputed EuRoC stereo rectification,
with host work: image I/O and remapping run on the host, and the card sees
only the rectified arrays. With the native runtime built, decode and
rectification run on its worker threads ahead of the tracking loop;
without it, on cv2 in the loop. Unlike the reference, an EuRoC sequence
without rectification maps also goes through the native pipeline (decode
only), and the image size of a PNG sequence comes from its header, so a
host without cv2 still reads KITTI and EuRoC PNG sequences; the frames are
the same bits either way.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


def with_lookahead(frames: Iterator["StereoFrame"]):
    """Yield (frame, next_images_or_None) with one-frame lookahead, so
    drivers can hand System.track_stereo the NEXT pair, as the reference's
    drivers do (the port's System accepts it and drops it)."""
    it = iter(frames)
    try:
        cur = next(it)
    except StopIteration:
        return
    for nxt in it:
        yield cur, (nxt.left, nxt.right)
        cur = nxt
    yield cur, None


def _image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image: from the IHDR chunk of a PNG, else by
    decoding it with cv2."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
        return (int.from_bytes(head[16:20], "big"),
                int.from_bytes(head[20:24], "big"))
    import cv2
    h, w = cv2.imread(path, cv2.IMREAD_GRAYSCALE).shape
    return w, h


@dataclass
class StereoFrame:
    timestamp: float
    left: np.ndarray    # (H,W) float32 grayscale, rectified
    right: np.ndarray
    imu: Optional[np.ndarray] = None  # (M,7) [t, ax, ay, az, gx, gy, gz]


class KittiOdometry:
    """KITTI odometry sequence dir: image_0/, image_1/, times.txt."""

    def __init__(self, seq_dir: str):
        self.dir = seq_dir
        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]
        self.left_dir = os.path.join(seq_dir, "image_0")
        self.right_dir = os.path.join(seq_dir, "image_1")
        self.names = sorted(os.listdir(self.left_dir))

    def __len__(self):
        return len(self.names)

    def __iter__(self) -> Iterator[StereoFrame]:
        yield from self.frames()

    def frames(self, prefetch: bool = True) -> Iterator[StereoFrame]:
        """Frame stream; with prefetch=True and the native runtime built,
        decode runs on its worker threads ahead of the tracking loop."""
        paths_l = [os.path.join(self.left_dir, n) for n in self.names]
        paths_r = [os.path.join(self.right_dir, n) for n in self.names]
        if prefetch:
            from . import native
            if native.available():
                w, h = _image_size(paths_l[0])
                pipe = native.PrefetchPipeline(paths_l, paths_r,
                                               width=w, height=h)
                try:
                    for (l, r), t in zip(pipe, self.times):
                        yield StereoFrame(t, l.astype(np.float32),
                                          r.astype(np.float32))
                finally:
                    pipe.close()
                return
        import cv2
        for lp, rp, t in zip(paths_l, paths_r, self.times):
            l = cv2.imread(lp, cv2.IMREAD_GRAYSCALE)
            r = cv2.imread(rp, cv2.IMREAD_GRAYSCALE)
            yield StereoFrame(t, l.astype(np.float32), r.astype(np.float32))


class EurocStereo:
    """EuRoC ASL layout: mav0/cam0/data, mav0/cam1/data + data.csv, with
    stereo rectification from the sensor extrinsics/intrinsics (either from
    the reference-style yaml settings or the dataset's sensor.yaml files).
    Optionally interleaves IMU measurements (mav0/imu0/data.csv) for the
    stereo-inertial mode."""

    def __init__(self, mav_dir: str, rect_from_settings: Optional[dict] = None,
                 with_imu: bool = False):
        self.dir = mav_dir
        cam0 = os.path.join(mav_dir, "cam0")
        cam1 = os.path.join(mav_dir, "cam1")
        self.ts = self._read_csv_times(os.path.join(cam0, "data.csv"))
        self.files0 = [os.path.join(cam0, "data", f"{t}.png") for t in self.ts]
        self.files1 = [os.path.join(cam1, "data", f"{t}.png") for t in self.ts]
        self.maps = None
        if rect_from_settings:
            import cv2
            s = rect_from_settings
            K_l = np.asarray(s["K_l"]).reshape(3, 3)
            K_r = np.asarray(s["K_r"]).reshape(3, 3)
            D_l = np.asarray(s["D_l"]).reshape(1, -1)
            D_r = np.asarray(s["D_r"]).reshape(1, -1)
            R_l = np.asarray(s["R_l"]).reshape(3, 3)
            R_r = np.asarray(s["R_r"]).reshape(3, 3)
            P_l = np.asarray(s["P_l"]).reshape(3, 4)
            P_r = np.asarray(s["P_r"]).reshape(3, 4)
            rows, cols = int(s["rows"]), int(s["cols"])
            self.maps = (
                cv2.initUndistortRectifyMap(K_l, D_l, R_l, P_l[:3, :3],
                                            (cols, rows), cv2.CV_32F),
                cv2.initUndistortRectifyMap(K_r, D_r, R_r, P_r[:3, :3],
                                            (cols, rows), cv2.CV_32F),
            )
        self.imu = None
        if with_imu:
            self.imu = self._read_imu(os.path.join(mav_dir, "imu0",
                                                   "data.csv"))

    @staticmethod
    def _read_csv_times(path):
        out = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                out.append(int(line.split(",")[0]))
        return out

    @staticmethod
    def _read_imu(path):
        rows = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                v = [float(x) for x in line.strip().split(",")]
                # csv: t[ns], gx, gy, gz, ax, ay, az -> [t_s, a, g]
                rows.append([v[0] * 1e-9, v[4], v[5], v[6], v[1], v[2], v[3]])
        return np.asarray(rows)

    def __len__(self):
        return len(self.ts)

    def _attach_imu(self, t, prev_t):
        if self.imu is None:
            return None
        lo = prev_t if prev_t is not None else -np.inf
        sel = (self.imu[:, 0] > lo) & (self.imu[:, 0] <= t)
        return self.imu[sel]

    def __iter__(self) -> Iterator[StereoFrame]:
        yield from self.frames()

    def frames(self, prefetch: bool = True) -> Iterator[StereoFrame]:
        """Frame stream; with prefetch=True and the native runtime built,
        decode AND rectification run on its worker threads ahead of the
        tracking loop."""
        if prefetch:
            from . import native
            if native.available():
                rect = None
                if self.maps is not None:
                    (m1l, m2l), (m1r, m2r) = self.maps
                    h, w = m1l.shape[:2]
                    rect = np.stack([m1l, m2l, m1r, m2r]).astype(np.float32)
                else:
                    w, h = _image_size(self.files0[0])
                pipe = native.PrefetchPipeline(self.files0, self.files1,
                                               width=w, height=h,
                                               rect_maps=rect)
                prev_t = None
                try:
                    for (l, r), t_ns in zip(pipe, self.ts):
                        t = t_ns * 1e-9
                        imu_chunk = self._attach_imu(t, prev_t)
                        prev_t = t
                        yield StereoFrame(t, l.astype(np.float32),
                                          r.astype(np.float32), imu_chunk)
                finally:
                    pipe.close()
                return
        import cv2
        prev_t = None
        for i, t_ns in enumerate(self.ts):
            l = cv2.imread(self.files0[i], cv2.IMREAD_GRAYSCALE)
            r = cv2.imread(self.files1[i], cv2.IMREAD_GRAYSCALE)
            if l is None or r is None:
                continue
            if self.maps is not None:
                (m1l, m2l), (m1r, m2r) = self.maps
                l = cv2.remap(l, m1l, m2l, cv2.INTER_LINEAR)
                r = cv2.remap(r, m1r, m2r, cv2.INTER_LINEAR)
            t = t_ns * 1e-9
            imu_chunk = self._attach_imu(t, prev_t)
            prev_t = t
            yield StereoFrame(t, l.astype(np.float32), r.astype(np.float32),
                              imu_chunk)


class TumRgbd:
    """TUM RGB-D: rgb.txt + depth.txt with timestamp association (as the
    TUM benchmark's associate.py)."""

    def __init__(self, seq_dir: str, depth_factor: float = 5000.0,
                 max_dt: float = 0.02):
        self.dir = seq_dir
        self.depth_factor = depth_factor
        rgb = self._read_list(os.path.join(seq_dir, "rgb.txt"))
        dep = self._read_list(os.path.join(seq_dir, "depth.txt"))
        self.pairs = []
        dts = np.asarray([t for t, _ in dep])
        for t, f in rgb:
            j = int(np.searchsorted(dts, t))
            best, bd = -1, max_dt
            for k in (j - 1, j):
                if 0 <= k < len(dts) and abs(dts[k] - t) <= bd:
                    best, bd = k, abs(dts[k] - t)
            if best >= 0:
                self.pairs.append((t, f, dep[best][1]))

    @staticmethod
    def _read_list(path):
        out = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                t, p = line.strip().split()[:2]
                out.append((float(t), p))
        return out

    def __len__(self):
        return len(self.pairs)

    def __iter__(self):
        import cv2
        for t, rgb_f, dep_f in self.pairs:
            img = cv2.imread(os.path.join(self.dir, rgb_f),
                             cv2.IMREAD_GRAYSCALE)
            dep = cv2.imread(os.path.join(self.dir, dep_f),
                             cv2.IMREAD_UNCHANGED)
            depth = dep.astype(np.float32) / self.depth_factor
            yield t, img.astype(np.float32), depth
