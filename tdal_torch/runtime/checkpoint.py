"""Step-numbered checkpoints with latest and best markers, and the import of ``tdal``'s.

Port of ``tdal/runtime/checkpoint.py``.

- ``CheckpointManager`` (the labeler tools' best-by-eval-accuracy saving,
  tools/static_train.py:149-165): each checkpoint is one ``torch.save`` file
  ``ckpt_<step>.pt`` of a dict of state dicts beside its ``ckpt_<step>.json`` meta;
  ``latest.json`` and ``best.json`` name a step. The newest ``max_to_keep`` checkpoints
  are kept, and the best one always. ``use_async=True`` writes on a background thread;
  ``wait()`` joins it and then writes the markers, and ``restore`` waits first.
- ``restore_tdal`` reads the directories of ``tdal``'s ``CheckpointManager``
  (``ckpt_%08d/`` orbax step directories, ``latest.json``, ``best.json``,
  ``meta.json``) through ``tdal_torch.runtime.orbax_format``, which needs only numpy:
  the tree comes back as nested dicts of numpy arrays.
- ``load_checkpoint_uri``: a local directory in either package's layout, a ``.npz`` of
  flat ``a/b/c`` keys, or a ``file://`` / ``http(s)://`` URL of either, fetched once
  into a cache (reference torchie/trainer/checkpoint.py:96-174).
- ``migrate_legacy_conv_params`` and ``load_params_tolerant``: ``tdal``'s migration of
  pre-FusedConvBN trees and its shape-tolerant overlay, on nested dicts of arrays, with
  the loud error on a layer rename.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import tarfile
import threading
import urllib.request
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tdal_torch.runtime.orbax_format import is_orbax_step_dir, read_step_dir


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 5,
                 use_async: bool = False):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._async = use_async
        self._pending = []  # (thread, errors, step, meta, is_best) awaiting wait()

    def _path(self, step: int, suffix: str) -> Path:
        return self.directory / f"ckpt_{step:08d}{suffix}"

    def save(self, step: int, state: dict, meta: Optional[dict] = None,
             is_best: bool = False) -> Path:
        """``state``: a dict of state dicts (or tensors); saved on the CPU. With
        ``use_async`` the state is copied to the CPU now and written in the
        background."""
        path = self._path(step, ".pt")
        meta = {**(meta or {}), "step": step}
        if not self._async:
            torch.save(_to_cpu(state), path)
            self._write_markers(step, meta, is_best)
            self._gc()
            return path
        host, errors = _to_cpu(state, clone=True), []

        def write():
            try:
                torch.save(host, path)
            except BaseException as e:  # re-raised by wait()
                errors.append(e)

        thread = threading.Thread(target=write, name=f"ckpt-{step}", daemon=True)
        thread.start()
        self._pending.append((thread, errors, step, meta, is_best))
        return path

    def wait(self):
        """Block until every background save has been written, then write its meta
        and markers (a step's markers appear only once its file is whole)."""
        pending, self._pending = self._pending, []
        for thread, errors, step, meta, is_best in pending:
            thread.join()
            if errors:
                raise errors[0]
            self._write_markers(step, meta, is_best)
        if pending:
            self._gc()

    def _write_markers(self, step: int, meta: dict, is_best: bool):
        self._path(step, ".json").write_text(json.dumps(meta, default=float))
        (self.directory / "latest.json").write_text(json.dumps({"step": step}))
        if is_best:
            (self.directory / "best.json").write_text(json.dumps(meta, default=float))

    def _gc(self):
        best = self.best_step()
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.max_to_keep)]:
            if s != best:
                self._path(s, ".pt").unlink(missing_ok=True)
                self._path(s, ".json").unlink(missing_ok=True)

    def all_steps(self) -> list:
        return [int(p.stem.split("_")[1]) for p in self.directory.glob("ckpt_*.pt")]

    def _marked(self, name: str) -> Optional[int]:
        marker = self.directory / name
        if marker.exists():
            step = json.loads(marker.read_text())["step"]
            if self._path(step, ".pt").exists():
                return step
        return None

    def latest_step(self) -> Optional[int]:
        step = self._marked("latest.json")
        if step is None and self.all_steps():
            step = max(self.all_steps())
        return step

    def best_step(self) -> Optional[int]:
        return self._marked("best.json")

    def restore(self, step: Optional[int] = None, map_location="cpu"):
        """(state, meta) of checkpoint ``step``; None means the latest."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        state = torch.load(self._path(step, ".pt"), map_location=map_location,
                           weights_only=True)
        meta_path = self._path(step, ".json")
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {"step": step}
        return state, meta


def _to_cpu(tree, clone: bool = False):
    """``tree`` on the CPU; with ``clone`` a CPU tensor is copied too, so that later
    in-place updates do not reach a save still in flight."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.clone() if clone and t.device == tree.device else t
    if isinstance(tree, dict):
        return {k: _to_cpu(v, clone) for k, v in tree.items()}
    return tree


# -- tdal's checkpoints ----------------------------------------------------------------


def _tdal_steps(directory: Path) -> list:
    return [int(p.name.split("_")[1]) for p in directory.glob("ckpt_*") if p.is_dir()]


def _tdal_marked(directory: Path, name: str) -> Optional[int]:
    marker = directory / name
    if marker.exists():
        step = json.loads(marker.read_text())["step"]
        if (directory / f"ckpt_{step:08d}").exists():
            return step
    return None


def is_tdal_checkpoint(path) -> bool:
    """Whether ``path`` is one of ``tdal``'s orbax step directories or a directory of
    them (a ``CheckpointManager``'s), told apart from the port's ``*.pt`` layouts by
    orbax's files."""
    path = Path(path)
    if not path.is_dir():
        return False
    return is_orbax_step_dir(path) or any(is_orbax_step_dir(p)
                                          for p in path.glob("ckpt_*") if p.is_dir())


def restore_tdal(directory, step: Optional[int] = None, prefer_best: bool = False):
    """(tree, meta) of a checkpoint that ``tdal``'s ``CheckpointManager`` wrote.

    ``directory`` is the manager's directory or one step directory. The step is
    ``step``, else with ``prefer_best`` the ``best.json`` one, else the ``latest.json``
    one, else the highest; a marker whose step directory is gone is passed over, as in
    ``tdal``'s ``latest_step`` / ``best_step``."""
    directory = Path(directory)
    if is_orbax_step_dir(directory):
        path = directory
    else:
        if step is None and prefer_best:
            step = _tdal_marked(directory, "best.json")
        if step is None:
            step = _tdal_marked(directory, "latest.json")
        if step is None and _tdal_steps(directory):
            step = max(_tdal_steps(directory))
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        path = directory / f"ckpt_{step:08d}"
    tree = read_step_dir(path)
    meta_path = path / "meta.json"
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
    else:
        meta = {"step": int(path.name.split("_")[1]) if path.name.startswith("ckpt_") else step}
    return tree, meta


def _restore_local(path: Path):
    if is_tdal_checkpoint(path):
        return restore_tdal(path)
    return CheckpointManager(path).restore()


def _unflatten(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_checkpoint_uri(uri: str, cache_dir=None, logger=None):
    """(tree, meta) of the checkpoint at ``uri`` (pretrained-zoo workflow).

    A local path is a checkpoint directory of either package (``tdal``'s orbax
    directories are told apart by their files) or a ``.npz`` of flat ``a/b/c`` keys.
    ``http(s)://`` and ``file://`` URLs (a ``.npz``, or a tarball of one checkpoint
    directory) are fetched once into ``cache_dir`` (``~/.cache/tdal_torch`` by default)
    under the first 16 hex digits of the URL's sha256, and a tarball is extracted with
    tarfile's ``data`` filter, which refuses absolute paths, ``..``, links out of the
    tree and device files."""
    if "://" not in uri:
        path = Path(uri)
        if path.suffix == ".npz":
            return _unflatten(dict(np.load(path))), {}
        return _restore_local(path)
    cache_dir = Path(cache_dir or Path.home() / ".cache" / "tdal_torch")
    cache_dir.mkdir(parents=True, exist_ok=True)
    name = hashlib.sha256(uri.encode()).hexdigest()[:16]
    suffix = ".npz" if uri.endswith(".npz") else ".tar.gz"
    local = cache_dir / (name + suffix)
    if not local.exists():
        if logger:
            logger.info(f"downloading checkpoint {uri} -> {local}")
        tmp = local.with_suffix(local.suffix + ".part")
        with urllib.request.urlopen(uri) as r, open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
        tmp.replace(local)
    if suffix == ".npz":
        return _unflatten(dict(np.load(local))), {}
    extract = cache_dir / name
    if not extract.exists():
        with tarfile.open(local) as tf:
            tf.extractall(extract, filter="data")
    # the archive holds one checkpoint-manager directory
    roots = [p for p in extract.iterdir() if p.is_dir()]
    one = len(roots) == 1 and not (extract / "latest.json").exists()
    return _restore_local(roots[0] if one else extract)


# -- tolerant loading ------------------------------------------------------------------


def migrate_legacy_conv_params(state: dict) -> dict:
    """Rewrite pre-FusedConvBN checkpoint subtrees to the current layout, as ``tdal``
    does: sibling ``Conv_N`` (a 3x3 4-d kernel, no bias) and ``BatchNorm_N`` in the
    ``params`` collection become ``FusedConvBN_N {kernel, scale, bias}``, and
    ``batch_stats``' ``BatchNorm_N`` at the same module path becomes ``FusedConvBN_N``.
    The kernel alone decides, so a strided 3x3 conv + BN pair is renamed too. Trees
    without a ``params`` collection, and subtrees that do not match, pass through."""
    if not isinstance(state, dict) or "params" not in state:
        return state
    renames = []  # (module path, old BN name, new name)

    def walk(tree, path):
        if not isinstance(tree, dict):
            return tree
        out, consumed = {}, set()
        for m, sub in tree.items():
            if (m.startswith("Conv_") and isinstance(sub, dict) and "kernel" in sub
                    and "bias" not in sub):
                idx = m.split("_", 1)[1]
                bn, k = f"BatchNorm_{idx}", sub["kernel"]
                if (bn in tree and isinstance(tree[bn], dict) and getattr(k, "ndim", 0) == 4
                        and k.shape[0] == 3 and k.shape[1] == 3):
                    out[f"FusedConvBN_{idx}"] = {"kernel": k, **tree[bn]}
                    consumed.update({m, bn})
                    renames.append((path, bn, f"FusedConvBN_{idx}"))
                    continue
            if m not in consumed:
                out[m] = walk(sub, path + (m,))
        for m in consumed:
            out.pop(m, None)
        return out

    new_state = dict(state)
    new_state["params"] = walk(state["params"], ())
    if "batch_stats" in state and renames:
        bs = copy.deepcopy(state["batch_stats"])
        for path, old, new in renames:
            node = bs
            for p in path:
                node = node.get(p) if isinstance(node, dict) else None
                if node is None:
                    break
            if isinstance(node, dict) and old in node:
                node[new] = node.pop(old)
        new_state["batch_stats"] = bs
    return new_state


def _flatten(tree, path=()) -> list:
    """[(key path, leaf)] in jax's order for dicts (sorted keys)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (k,))]
    return [(path, tree)]


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def load_params_tolerant(restored: dict, target: dict, logger=None,
                         allow_partial_modules: bool = False) -> dict:
    """``target``'s tree with each leaf replaced by ``restored``'s at the same path
    where the shapes agree; missing and mismatched leaves keep ``target``'s (reference
    load_state_dict(strict=False) with shape skips, torchie/trainer/checkpoint.py:
    42-94). Legacy trees are migrated first (``migrate_legacy_conv_params``). If a
    whole target module restores nothing while the checkpoint has unconsumed keys
    under the same parent, that is a layer rename, not a missing stage: this raises
    ``ValueError`` unless ``allow_partial_modules``."""
    restored = migrate_legacy_conv_params(restored)
    flat_r = dict(_flatten(restored))
    flat_t = _flatten(target)
    used, skipped, leaves = set(), [], {}
    for path, leaf in flat_t:
        if path in flat_r and np.shape(flat_r[path]) == np.shape(leaf):
            leaves[path] = flat_r[path]
            used.add(path)
        else:
            skipped.append(path)
            if logger is not None:
                logger.warning(f"checkpoint: skipping {_keystr(path)}")
            leaves[path] = leaf
    if skipped and not allow_partial_modules:
        modules = {}
        for path, _ in flat_t:
            modules.setdefault(path[:-1], []).append(path)
        unconsumed_parents = {p[:-1][:-1] for p in flat_r if p not in used}
        skipped_set = set(skipped)
        for mod, paths in modules.items():
            if any(p in used for p in paths):
                continue
            if all(p in skipped_set for p in paths) and mod[:-1] in unconsumed_parents:
                names = [_keystr(p) for p in paths[:4]]
                raise ValueError(
                    "checkpoint restore left module "
                    f"{_keystr(mod) or '<root>'} entirely at init "
                    f"({names}...) while unrestored checkpoint keys exist under "
                    "the same parent — this looks like a layer rename, not a "
                    "missing stage. Migrate the checkpoint or pass "
                    "allow_partial_modules=True if this is intentional.")

    def rebuild(tree, path):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        return leaves[path]

    return rebuild(target, ())
