"""Per-sequence sharding of the offboard pipeline: the port of ``tdal/pipeline/shard.py``.

The heavy stages (detect, track, trackData extraction, labeler inference) are
embarrassingly parallel over driving sequences: tracking state never crosses a sequence
boundary (the reference tracker resets at frame 0, waymo_tracking/test.py:88-134). This
module partitions a frame-info map into balanced per-sequence shards and runs a stage
over them, in this process or in worker processes, in place of the reference's "run
the CLI 16 times with --split i" (waymo_common.py:208-218).

Worker processes are spawned, not forked (a fork of a process whose CUDA or thread
pools are up can hang), so with ``processes=True`` the stage function must pickle: a
function defined at a module's top level.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
from pathlib import Path
from typing import Callable, Dict, List, Sequence


def sequence_of(token: str) -> int:
    """Sequence id parsed from a frame token ('seq_<k>_frame_<j>.pkl')."""
    return int(token.split("_")[1])


def partition_by_sequence(info_map: Dict[str, dict], n_shards: int) -> List[Dict[str, dict]]:
    """Split a token->info map into n_shards maps, whole sequences only,
    greedily balanced by frame count (largest-first bin packing)."""
    seqs: Dict[int, list] = {}
    for token in info_map:
        seqs.setdefault(sequence_of(token), []).append(token)
    loads = [0] * n_shards
    shards: List[Dict[str, dict]] = [dict() for _ in range(n_shards)]
    for seq_id, tokens in sorted(seqs.items(), key=lambda kv: -len(kv[1])):
        tgt = loads.index(min(loads))
        loads[tgt] += len(tokens)
        for t in tokens:
            shards[tgt][t] = info_map[t]
    return shards


def shard_detections(detections: Dict[str, dict], shard_infos: Dict[str, dict]) -> Dict[str, dict]:
    """Restrict a detections map to one shard's tokens."""
    return {t: detections[t] for t in shard_infos if t in detections}


def _call(job):
    stage_fn, shard_id, shard = job
    return stage_fn(shard_id, shard)


def _in_processes(stage_fn, jobs) -> list:
    """``stage_fn(i, shard)`` of each (i, shard) in its own spawned process, results in
    the order of ``jobs``."""
    with mp.get_context("spawn").Pool(len(jobs)) as pool:
        return pool.map(_call, [(stage_fn, i, s) for i, s in jobs])


def run_sharded(
    stage_fn: Callable[[int, Dict[str, dict]], object],
    info_map: Dict[str, dict],
    n_shards: int = None,
    processes: bool = False,
) -> List[object]:
    """Run stage_fn(shard_id, shard_info_map) over per-sequence shards.

    processes=False: sequential in this process (one card serializes the stages
    anyway; sharding still bounds memory and enables resume). processes=True: one
    spawned worker per non-empty shard (host-bound stages). Results return in shard
    order."""
    n_shards = n_shards or (os.cpu_count() or 8)
    shards = partition_by_sequence(info_map, n_shards)
    jobs = [(i, s) for i, s in enumerate(shards) if s]
    if not processes:
        return [stage_fn(i, s) for i, s in jobs]
    return _in_processes(stage_fn, jobs)


def merge_dicts(results: Sequence[Dict]) -> Dict:
    """Merge per-shard dict outputs (e.g. detections or trackData maps)."""
    out: Dict = {}
    for r in results:
        out.update(r)
    return out


class _Resumable:
    """``stage_fn`` whose result for a shard is written once to ``out_dir`` (tmp +
    rename) and read back from there when it exists."""

    def __init__(self, stage_fn, out_dir: Path):
        self.stage_fn, self.out_dir = stage_fn, out_dir

    def path(self, i: int) -> Path:
        return self.out_dir / f"shard_{i:04d}.pkl"

    def __call__(self, i, shard):
        p = self.path(i)
        if p.exists():
            with open(p, "rb") as f:
                return pickle.load(f)
        result = self.stage_fn(i, shard)
        tmp = p.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        tmp.rename(p)
        return result


def run_sharded_resumable(
    stage_fn: Callable[[int, Dict[str, dict]], object],
    info_map: Dict[str, dict],
    out_dir,
    n_shards: int = 16,
    processes: bool = False,
) -> List[object]:
    """run_sharded with per-shard checkpointing: a 200k-frame array job that dies
    mid-way resumes by skipping every shard whose output pickle exists.

    Each shard's result is written to out_dir/shard_{i:04d}.pkl atomically (tmp +
    rename); a restart recomputes only the missing shards (the failure the reference
    handled by rerunning `--split i` CLI invocations by hand, SURVEY §5.3)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    run_one = _Resumable(stage_fn, out_dir)
    jobs = [(i, s) for i, s in enumerate(partition_by_sequence(info_map, n_shards)) if s]
    if not processes:
        return [run_one(i, s) for i, s in jobs]
    todo = [(i, s) for i, s in jobs if not run_one.path(i).exists()]
    if todo:
        _in_processes(run_one, todo)
    return [run_one(i, s) for i, s in jobs]
