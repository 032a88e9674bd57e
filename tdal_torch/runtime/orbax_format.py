"""A reader for the step directories that ``tdal``'s ``CheckpointManager.save`` writes.

orbax writes through tensorstore: one OCDBT key-value database per step directory
(``manifest.ocdbt``, b-tree nodes and data files under ``d/`` and
``ocdbt.process_0/d/``), holding one zarr v2 array per leaf (``<name>/.zarray`` and the
chunks ``<name>/0.0``...), with ``_METADATA`` naming the leaves. This module parses all
three layers with the standard library and numpy (zstd through
``tdal_torch.runtime.zstd``), so a machine without orbax, tensorstore or zstandard can
read ``tdal``'s checkpoints.

OCDBT, as written by tensorstore 0.1.80:

- Every manifest and b-tree node is ``magic (u32 big-endian) | length (u64) | version
  (varint, 0) | compression (varint: 0 none, 1 zstd) | body | crc32c (u32)``; the
  checksum covers everything before it and is verified.
- The manifest body is the config (uuid, manifest kind, inline and node size limits,
  version-tree arity, compression) and the newest versions, each with the root node's
  (data file, offset, length) and height; data file paths are relative to the
  database's directory.
- Leaf nodes hold prefix-compressed keys with their values inline or as (data file,
  offset) references; interior nodes hold each child's first key, the prefix common to
  its subtree (which the child's keys omit), and its (data file, offset, length).

Anything outside that (another orbax layout, zarr v3, another compressor or filter)
raises ``ValueError`` naming the field. ``read_step_dir(path)`` returns the nested dict
of numpy arrays; a bfloat16 leaf comes back as a ``torch.bfloat16`` tensor, since numpy
has no such type.
"""

from __future__ import annotations

import ast
import json
import math
from pathlib import Path

import numpy as np
import torch

from tdal_torch.runtime import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1

# -- crc32c ----------------------------------------------------------------------------


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- OCDBT -----------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def _need(self, n: int):
        if self.pos + n > len(self.buf):
            raise ValueError(f"OCDBT {self.what}: truncated")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            self._need(1)
            b = self.buf[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: varint too long")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def bytes(self, n: int) -> bytes:
        self._need(n)
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.bytes(1)[0]


def _decode_envelope(raw: bytes, magic: int, what: str) -> bytes:
    """Check the magic, length and crc32c of a manifest or node; return its body."""
    if len(raw) < 18 or int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"OCDBT {what}: bad magic")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise ValueError(f"OCDBT {what}: length field does not match the data")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"OCDBT {what}: crc32c mismatch")
    r = _Reader(raw[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: unsupported format version {version}")
    body = raw[r.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise ValueError(f"OCDBT {what}: unsupported compression {compression}")
    return body


def _data_file_table(r: _Reader) -> list:
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the split of each path, not needed to read it
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"OCDBT {r.what}: bad data file path prefix")
        prev = prev[:p] + r.bytes(s)
        paths.append(prev.decode())
    return paths


class OcdbtDatabase:
    """The newest version of the OCDBT database under ``root``: ``items()`` maps each
    key (bytes) to its value (bytes)."""

    def __init__(self, root):
        self.root = Path(root)
        self._files = {}
        raw = (self.root / "manifest.ocdbt").read_bytes()
        r = _Reader(_decode_envelope(raw, MANIFEST_MAGIC, "manifest"), "manifest")
        r.bytes(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"OCDBT manifest: manifest_kind {kind} (numbered) is not supported")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        method = r.varint()
        if method == 1:
            r.bytes(4)  # zstd level
        elif method != 0:
            raise ValueError(f"OCDBT manifest: compression_method {method} is not supported")
        paths = _data_file_table(r)
        n = r.varint()
        gens, heights = r.varints(n), [r.byte() for _ in range(n)]
        files, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
        r.varints(n)  # commit times
        if n == 0:
            raise ValueError("OCDBT manifest: no version is stored inline")
        i = max(range(n), key=gens.__getitem__)
        self._root = None
        if offsets[i] != _NO_ROOT:
            self._root = (paths[files[i]], offsets[i], lengths[i], heights[i])

    def _read(self, path: str, offset: int, length: int) -> bytes:
        f = self._files.get(path)
        if f is None:
            full = (self.root / path).resolve()
            if self.root.resolve() not in full.parents:
                raise ValueError(f"OCDBT: data file {path!r} lies outside the database")
            f = self._files[path] = open(full, "rb")
        f.seek(offset)
        data = f.read(length)
        if len(data) != length:
            raise ValueError(f"OCDBT: data file {path!r} is shorter than a reference into it")
        return data

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}

    def items(self) -> dict:
        out = {}
        try:
            if self._root is not None:
                path, off, length, height = self._root
                self._walk(path, off, length, height, b"", out)
        finally:
            self.close()
        return out

    def _walk(self, path, off, length, height, prefix: bytes, out: dict):
        body = _decode_envelope(self._read(path, off, length), NODE_MAGIC, "b-tree node")
        r = _Reader(body, "b-tree node")
        if r.byte() != height:
            raise ValueError("OCDBT b-tree node: height differs from its reference")
        paths = _data_file_table(r)
        n = r.varint()
        pre = [0] + r.varints(max(n - 1, 0))
        suf = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for p, s in zip(pre, suf):
            if p > len(prev):
                raise ValueError("OCDBT b-tree node: bad key prefix")
            prev = prev[:p] + r.bytes(s)
            keys.append(prev)
        if height:
            files, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            for i, key in enumerate(keys):
                if common[i] > len(key) or files[i] >= len(paths):
                    raise ValueError("OCDBT b-tree node: bad child reference")
                self._walk(paths[files[i]], offs[i], lens[i], height - 1,
                           prefix + key[:common[i]], out)
            return
        vlen = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k > 1 for k in kinds):
            raise ValueError("OCDBT b-tree node: unknown value kind")
        files, offs = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(files, offs)))
        for i, key in enumerate(keys):
            if i in refs:
                fid, o = refs[i]
                if fid >= len(paths):
                    raise ValueError("OCDBT b-tree node: bad data file id")
                out[prefix + key] = self._read(paths[fid], o, vlen[i])
            else:
                out[prefix + key] = r.bytes(vlen[i])
        if r.pos != len(body):
            raise ValueError("OCDBT b-tree node: bytes left over")


# -- zarr v2 ---------------------------------------------------------------------------

_DTYPES = {"bfloat16": "<u2"}


def _zarr_dtype(spec):
    if not isinstance(spec, str):
        raise ValueError(f"zarr .zarray: dtype {spec!r} (structured) is not supported")
    try:
        dt = np.dtype(_DTYPES.get(spec, spec))
    except TypeError as e:
        raise ValueError(f"zarr .zarray: dtype {spec!r} is not supported") from e
    if dt.kind not in "biuf":
        raise ValueError(f"zarr .zarray: dtype {spec!r} is not supported")
    return dt


def _fill(meta: dict, dt: np.dtype, bf16: bool):
    fv = meta.get("fill_value")
    if fv is None:
        return 0
    if isinstance(fv, str):
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}.get(fv)
        if value is None:
            raise ValueError(f"zarr .zarray: fill_value {fv!r} is not supported")
        fv = value
    if bf16:
        f32 = np.array([fv], np.float32).view(np.uint32)[0]
        return int(f32 >> 16)
    return fv


def read_zarr(kv: dict, name: str):
    """The zarr v2 array stored under ``name`` in the key-value dict ``kv``."""
    key = f"{name}/.zarray".encode()
    if key not in kv:
        raise ValueError(f"zarr: no array {name!r} in the checkpoint")
    meta = json.loads(kv[key])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr .zarray of {name!r}: zarr_format {meta.get('zarr_format')!r}")
    if meta.get("filters"):
        raise ValueError(f"zarr .zarray of {name!r}: filters {meta['filters']!r} are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"zarr .zarray of {name!r}: compressor {comp!r} is not supported")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"zarr .zarray of {name!r}: order {order!r}")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"zarr .zarray of {name!r}: dimension_separator {sep!r}")
    bf16 = meta.get("dtype") == "bfloat16"
    dt = _zarr_dtype(meta.get("dtype"))
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"zarr .zarray of {name!r}: chunks {chunks} do not fit shape {shape}")
    out = np.full(shape, _fill(meta, dt, bf16), dtype=dt)
    grid = [(s + c - 1) // c for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        ckey = sep.join(str(i) for i in idx) if shape else "0"
        raw = kv.get(f"{name}/{ckey}".encode())
        if raw is None:
            continue  # a chunk never written holds the fill value
        if comp is not None:
            raw = zstd.decompress(raw)
        n = int(np.prod(chunks))
        if len(raw) != n * dt.itemsize:
            raise ValueError(f"zarr chunk {name}/{ckey}: {len(raw)} bytes, expected "
                             f"{n * dt.itemsize}")
        block = np.frombuffer(raw, dt).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
    out = out.astype(dt.newbyteorder("="), copy=False)
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(out).view(np.int16)).view(torch.bfloat16)
    return out


# -- orbax -----------------------------------------------------------------------------


def is_orbax_step_dir(path) -> bool:
    path = Path(path)
    return (path / "_METADATA").is_file() and (
        (path / "manifest.ocdbt").is_file() or (path / "_CHECKPOINT_METADATA").is_file())


def _database_root(step_dir: Path) -> Path:
    if (step_dir / "manifest.ocdbt").is_file():
        return step_dir
    per_process = sorted(step_dir.glob("ocdbt.process_*/manifest.ocdbt"))
    if len(per_process) == 1:
        return per_process[0].parent
    raise ValueError(f"orbax step directory {step_dir}: no single OCDBT manifest")


def read_step_dir(step_dir) -> dict:
    """The tree that orbax's ``PyTreeCheckpointer`` saved into ``step_dir``."""
    step_dir = Path(step_dir)
    meta = json.loads((step_dir / "_METADATA").read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{step_dir}/_METADATA: use_zarr3 true is not supported")
    if meta.get("use_ocdbt") is False:
        raise ValueError(f"{step_dir}/_METADATA: use_ocdbt false is not supported")
    tree_meta = meta.get("tree_metadata")
    if not isinstance(tree_meta, dict):
        raise ValueError(f"{step_dir}/_METADATA: no tree_metadata")
    kv = OcdbtDatabase(_database_root(step_dir)).items()
    tree = {}
    for key_str, leaf_meta in tree_meta.items():
        try:
            key = ast.literal_eval(key_str)
        except (ValueError, SyntaxError) as e:
            raise ValueError(f"_METADATA: tree_metadata key {key_str!r} is not a tuple") from e
        if not isinstance(key, tuple) or not key:
            raise ValueError(f"_METADATA: tree_metadata key {key_str!r} is not a tuple")
        for km in leaf_meta.get("key_metadata", []):
            if km.get("key_type") != 2:
                raise ValueError(f"_METADATA: key_type {km.get('key_type')!r} of {key_str} "
                                 "(only dict keys are supported)")
        vtype = leaf_meta.get("value_metadata", {}).get("value_type")
        if vtype not in ("np.ndarray", "jax.Array"):
            raise ValueError(f"_METADATA: value_type {vtype!r} of {key_str} is not supported")
        node = tree
        for k in key[:-1]:
            node = node.setdefault(str(k), {})
        node[str(key[-1])] = read_zarr(kv, ".".join(str(k) for k in key))
    return tree
