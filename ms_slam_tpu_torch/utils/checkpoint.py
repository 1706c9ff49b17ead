"""Map checkpoint / resume.

Port of `ms_slam_tpu/utils/checkpoint.py`, in the same file format, so that
a map saved by either package loads in the other: one compressed npz with
every MapState field as `ms_<field>` in the reference's dtypes (descriptor
words as uint32; `mp_sparsified` comes out of the zeroing below as int64),
the host cursors as `meta_json`, and the keyframe database's BoW rows as
`db_rows`. Dead pool slots are zeroed before saving, so the file's size
follows the live map. Loading puts the map on the System's device and
leaves it LOST, to relocalize against the saved map.

What the format does not hold, in either package: the database's codebook
and its fit state (`_trained`, `_retrained`, `has_row`), and the inertial
state. After a load the stored rows come from the refit codebook while a
query is encoded with the initial one; the port keeps that behaviour of the
reference, since the format is shared.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from ..models.map_state import map_state_from_numpy, map_state_to_numpy

FORMAT_VERSION = 1


def md5_of_file(path: str) -> str:
    """Hex MD5 of a file (the reference system fingerprints its vocabulary
    so; here it checks a checkpoint's integrity)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_map(path: str, system) -> None:
    arrays = {f"ms_{k}": v for k, v in map_state_to_numpy(system.ms).items()}
    # dead pool slots carry stale bytes: zero them, so that the compressed
    # file's size follows the LIVE (post-sparsification) map
    kfv = arrays["ms_kf_valid"]
    kpv = arrays["ms_kp_valid"] & kfv[:, None]
    mpv = arrays["ms_mp_valid"]
    for k, a in arrays.items():
        name = k[3:]
        if name.startswith("kp_") and name != "kp_valid":
            arrays[k] = np.where(
                kpv.reshape(kpv.shape + (1,) * (a.ndim - 2)), a, 0)
        elif name == "obs_mp":
            arrays[k] = np.where(kpv, a, -1)
        elif (name.startswith("mp_")
                and name not in ("mp_valid", "mp_quarantine")):
            # (mp_quarantine survives: it guards freed slots on resume)
            arrays[k] = np.where(
                mpv.reshape(mpv.shape + (1,) * (a.ndim - 1)), a, 0)
    meta = {
        "version": FORMAT_VERSION,
        "n_kf": int(system.n_kf),
        "n_mp": int(system.n_mp),
        "kf_ord": int(system.kf_ord),
        "kf_free": [int(i) for i in system.kf_free],
        "kf_order": [int(i) for i in system.kf_order],
        "frame_id": int(system.frame_id),
        "state": system.state,
        "ref_kf": int(system.ref_kf),
        "sparsifier_done": sorted(int(i) for i in system._sparsifier.done)
        if system._sparsifier else [],
        "db_present": np.where(system.kf_db.present)[0].tolist()
        if system.kf_db is not None else [],
    }
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    if system.kf_db is not None:
        arrays["db_rows"] = system.kf_db.rows.detach().cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_map(path: str, system) -> None:
    """Restore a saved map into a freshly constructed System with matching
    static configuration: the map on the System's device, the database's
    rows on the database's."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {meta['version']} != "
                             f"{FORMAT_VERSION}")
        fields = {k[3:]: data[k] for k in data.files if k.startswith("ms_")}
        db_rows = data["db_rows"] if "db_rows" in data.files else None
    ms = map_state_from_numpy(fields, device=system.device)
    # each field in the System's own dtype: the zeroing of save_map writes
    # the bool mp_sparsified through np.where(.., 0) as int64 (in both
    # packages), which reads back as 0/1
    system.ms = type(ms)(*[t.to(getattr(system.ms, name).dtype)
                           for name, t in zip(ms._fields, ms)])
    system._obs_dirty = True
    system.n_kf = meta["n_kf"]
    system.n_mp = meta["n_mp"]
    system.kf_ord = meta.get("kf_ord", meta["n_kf"])
    system.kf_free = list(meta.get("kf_free", []))
    system.kf_order = list(meta.get("kf_order", range(meta["n_kf"])))
    system.frame_id = meta["frame_id"]
    system.ref_kf = meta["ref_kf"]
    # the file holds one map: every keyframe slot gets the active map's
    # Atlas label (left empty, as the reference leaves it, the first
    # keyframe that reuses a freed slot raises IndexError)
    system.kf_maps = [system.active_map] * meta["n_kf"]
    system.state = "LOST"   # must relocalize against the loaded map
    if system._sparsifier is not None:
        system._sparsifier.done = set(meta["sparsifier_done"])
    if system.kf_db is not None and db_rows is not None:
        system.kf_db.rows = torch.as_tensor(
            db_rows, dtype=torch.float32, device=system.kf_db.rows.device)
        for i in meta["db_present"]:
            system.kf_db.present[i] = True
