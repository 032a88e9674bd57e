"""Columnar per-frame point cache: the ``.tdc`` format of ``tdal/data/frame_cache.py``.

``build_cache`` writes, next to each frame pickle, one flat float32 blob of the
post-load point layout [xyz, tanh(intensity), elongation], so that a reader skips
the unpickling and the tanh. The format: a 16-byte little-endian header (magic
``"TDC1"``, rows, columns, 0) and the rows as float32. One numpy reader and writer
serve it; a file whose header or length is wrong raises. Files written by either
package are read by the other.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

MAGIC = 0x31434454  # "TDC1"
_HEADER = struct.Struct("<IIII")


def write_points_cache(path, points: np.ndarray) -> None:
    """points (N, D) float32 -> one .tdc file, written to a temporary name and then
    renamed, so that an interrupted write leaves no truncated file behind."""
    points = np.ascontiguousarray(points, np.float32)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(MAGIC, points.shape[0], points.shape[1], 0))
        f.write(points.tobytes())
    os.replace(tmp, path)


def read_points_cache(path) -> np.ndarray:
    """One .tdc file -> (N, D) float32; ValueError on a wrong header or length."""
    with open(path, "rb") as f:
        header = f.read(_HEADER.size)
        if len(header) < _HEADER.size:
            raise ValueError(f"truncated TDC header: {path}")
        magic, n, d, _ = _HEADER.unpack(header)
        if magic != MAGIC:
            raise ValueError(f"not a TDC file: {path}")
        body = f.read()
    if len(body) != n * d * 4:
        raise ValueError(f"TDC body of {len(body)} bytes, expected {n * d * 4}: {path}")
    return np.frombuffer(body, np.float32).reshape(n, d)


def cache_path_for(frame_path) -> Path:
    return Path(f"{frame_path}.tdc")


def build_cache(infos, logger=None, with_sweeps: bool = True) -> int:
    """Write a .tdc next to every frame pickle of ``infos`` (and its sweeps) that has
    none yet; returns the number of files written."""
    from tdal_torch.data.waymo_schema import load_pickle

    paths = []
    for info in infos:
        paths.append(info["path"])
        if with_sweeps:
            paths.extend(s["path"] for s in info.get("sweeps", []))
    n_written = 0
    for p in dict.fromkeys(paths):
        out = cache_path_for(p)
        if out.exists():
            continue
        obj = load_pickle(p)
        xyz = np.asarray(obj["lidars"]["points_xyz"], np.float32)
        feat = np.array(obj["lidars"]["points_feature"], np.float32)
        feat[:, 0] = np.tanh(feat[:, 0])
        write_points_cache(out, np.concatenate([xyz, feat], axis=1))
        n_written += 1
    if logger:
        logger.info(f"frame cache: wrote {n_written} .tdc files")
    return n_written


def read_frame_points(frame_path) -> np.ndarray | None:
    """The cached [xyz, tanh(intensity), elongation] of a frame pickle's path, or None
    when the frame has no .tdc file (then its pickle is the source)."""
    p = cache_path_for(frame_path)
    return read_points_cache(p) if p.exists() else None
