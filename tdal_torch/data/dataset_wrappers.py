"""Dataset wrappers: concatenation and epoch-repeat: port of
``tdal/data/dataset_wrappers.py``.

Both work on anything indexable with ``__len__`` (DetectionDataset, track datasets,
plain lists), take ``class_names`` from the first child and register in the DATASETS
registry so configs can dispatch on them.
"""

from __future__ import annotations

import bisect
from typing import Sequence

from tdal_torch.runtime.registry import DATASETS


@DATASETS.register_module
class ConcatDataset:
    """Index-concatenation of several datasets."""

    def __init__(self, datasets: Sequence):
        assert len(datasets) > 0, "ConcatDataset needs at least one dataset"
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)
        self.class_names = getattr(self.datasets[0], "class_names", None)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        ds = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds - 1] if ds > 0 else 0
        return self.datasets[ds][idx - prev]


@DATASETS.register_module
class RepeatDataset:
    """len = times * len(dataset); idx wraps.

    Amortizes epoch-boundary costs when the dataset is small."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = int(times)
        self.class_names = getattr(dataset, "class_names", None)
        self._ori_len = len(dataset)

    def __len__(self):
        return self.times * self._ori_len

    def __getitem__(self, idx: int):
        return self.dataset[idx % self._ori_len]
