"""Host batch loader (the PyTorch idiom for ``cl4wsis_tpu/data/loader.py``).

A ``torch.utils.data.DataLoader`` over the dataset with ``num_workers``
worker processes. Its batch sampler gives the JAX loader's order: the
epoch's permutation ``RandomState(seed + epoch).shuffle(arange(n))``, the
process's strided shard ``[process_index::process_count]``, then
full batches (a short last batch is dropped). Each index goes out with its epoch, as
``(epoch, index)``: a worker holds its own copy of the dataset, and the
epoch must reach it with the index, not through an attribute set in this
process (with ``persistent_workers`` the workers would otherwise keep
epoch 0 for ever). Batches come out in order, so their contents do not
depend on the number of workers.

The workers are started with the ``forkserver`` method: the trainer has
initialised CUDA (and started threads) before the first epoch starts
them, and a child forked from such a process inherits a CUDA context it
must not use and locks held by threads that do not exist in it. The fork
server is a fresh interpreter, started once a process, that imports
numpy, torch and the modules of this package the process has imported,
and never touches the card; the only threads it holds are numpy's BLAS
pool, which handles a fork, as under torch's default ``fork`` start.
Each worker is forked from it and imports only the main module's own
body, where ``spawn`` paid the import of torch and of the package in
every worker (10-15 s for four workers beside a busy trainer on the
card). The datasets give numpy and the mask library is host-only, so a
worker never touches the card. The workers persist across epochs until
:meth:`Loader.close`.
"""

from __future__ import annotations

import multiprocessing
import sys
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch


def collate(samples) -> Dict[str, torch.Tensor]:
    """Stack each key of the samples into a CPU tensor; drop `fname`."""
    return {k: torch.from_numpy(np.stack([s[k] for s in samples]))
            for k in samples[0] if k != "fname"}


def worker_context() -> multiprocessing.context.BaseContext:
    """The forkserver context, its server (when this call starts it) to
    import numpy, torch and the modules of this package imported here."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["numpy", "torch"] + sorted(
        m for m in sys.modules if m.split(".")[0] == __name__.split(".")[0]))
    return ctx


class EpochBatchSampler(torch.utils.data.Sampler):
    """The JAX loader's shuffled full batches of one process, as lists of
    ``(epoch, index)``; `epoch` is set before each epoch's iteration."""

    def __init__(self, n: int, batch_size: int, seed: int = 42,
                 process_index: int = 0, process_count: int = 1):
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def __len__(self) -> int:
        return self.n // self.process_count // self.batch_size

    def __iter__(self) -> Iterator[List[Tuple[int, int]]]:
        idxs = np.arange(self.n)
        np.random.RandomState(self.seed + self.epoch).shuffle(idxs)
        shard = idxs[self.process_index::self.process_count]
        bs = self.batch_size
        for b in range(len(self)):
            yield [(self.epoch, int(i)) for i in shard[b * bs:(b + 1) * bs]]


class Loader:
    """Shuffled epochs of collated batches, `num_workers` worker processes
    (0: in this process). With `pin_memory` the batches come in pinned
    host memory, ready for an asynchronous copy to the card."""

    def __init__(self, dataset, batch_size: int, seed: int = 42,
                 process_index: int = 0, process_count: int = 1,
                 num_workers: int = 4, pin_memory: bool = False):
        self.dataset = dataset
        self.sampler = EpochBatchSampler(len(dataset), batch_size, seed,
                                         process_index, process_count)
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self._loader = None

    def __len__(self) -> int:
        return len(self.sampler)

    def _data_loader(self) -> torch.utils.data.DataLoader:
        if self._loader is None:
            workers = self.num_workers > 0
            self._loader = torch.utils.data.DataLoader(
                self.dataset, batch_sampler=self.sampler,
                num_workers=self.num_workers, collate_fn=collate,
                pin_memory=self.pin_memory, persistent_workers=workers,
                prefetch_factor=2 if workers else None,
                multiprocessing_context=worker_context() if workers else None)
        return self._loader

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        loader = self._data_loader()
        self.sampler.epoch = epoch
        yield from loader

    def close(self) -> None:
        """Stop the worker processes, which persist across epochs: drop
        the DataLoader, whose persistent iterator shuts its workers down
        when it is freed. The next epoch builds a new one."""
        self._loader = None


def eval_samples(dataset, process_index: int = 0,
                 process_count: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Sequential batch-1 eval iterator (the reference protocol), samples
    as the dataset gives them (variable shapes, `gt_masks` (K, H, W) with
    K varying). Each process takes a strided shard."""
    for i in range(process_index, len(dataset), process_count):
        yield dataset[i]
