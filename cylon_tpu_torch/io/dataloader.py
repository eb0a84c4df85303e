"""Partitioned data loading for ML workloads — pycylon util.data parity
(counterpart of cylon_tpu.io.dataloader).

Reference: python/pycylon/util/data/DataManager.py (`DataLoader` /
`Partition` feeding the PyTorch demo pipelines) and
util/data/generator.py. The loader reads per-rank CSV/Parquet files into
cylon_tpu_torch Tables (on the context's device) and exports dense
numpy blocks for the training framework.
"""
from __future__ import annotations

import os
from math import ceil
from typing import List, Optional, Sequence

import numpy as np

from ..context import CylonContext
from ..data.table import Table
from ..status import Code, CylonError


class Partition:
    """An index-partitioned view over a dense sample block (reference:
    DataManager.Partition)."""

    def __init__(self, data: np.ndarray, index: Sequence[int]):
        self.data = data
        self.index = list(index)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int):
        return self.data[self.index[i]]


class DataLoader:
    """Load per-rank partitioned CSV/Parquet files into Tables and
    partition the dense export across workers (reference:
    DataManager.DataLoader)."""

    def __init__(self, ctx: CylonContext, source_dir: str,
                 source_files: Sequence[str], file_type: str = "csv"):
        if not os.path.isdir(source_dir):
            raise CylonError(Code.IOError, f"no such dir: {source_dir}")
        for f in source_files:
            if not os.path.exists(os.path.join(source_dir, f)):
                raise CylonError(Code.IOError, f"missing file: {f}")
        self._ctx = ctx
        self._dir = source_dir
        self._files = list(source_files)
        self._type = file_type
        self.tables: List[Table] = []

    def load(self) -> "DataLoader":
        from . import csv as _csv
        from . import parquet as _parquet

        reader = _csv.read_csv if self._type == "csv" \
            else _parquet.read_parquet
        self.tables = [reader(self._ctx, os.path.join(self._dir, f))
                       for f in self._files]
        return self

    def table(self, i: int = 0) -> Table:
        return self.tables[i]

    def to_numpy_blocks(self) -> List[np.ndarray]:
        return [t.to_numpy(order="C") for t in self.tables]

    def partitions(self, n_workers: int, seed: Optional[int] = 0,
                   table_index: int = 0) -> List[Partition]:
        """Shuffled, near-equal index partitions of one table's dense
        export — one per DL worker (reference: DataPartitioner)."""
        block = self.tables[table_index].to_numpy(order="C")
        n = block.shape[0]
        idx = np.arange(n)
        if seed is not None:
            np.random.default_rng(seed).shuffle(idx)
        per = ceil(n / max(n_workers, 1))
        return [Partition(block, idx[w * per:(w + 1) * per])
                for w in range(n_workers)]
