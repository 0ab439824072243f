"""The port's loader (cl4wsis_tpu_torch.data.loader) against the JAX
package's Loader and GrainLoader on the CPU: the same batches with 0 and 2
worker processes, fresh augmentation every epoch with persistent workers,
rank shards, lengths, and the trainer taking the loader's tensors without
another host copy (on the card: tests/test_torch_kernels_cuda.py). Every
comparison is exact."""

import hashlib
import multiprocessing
import time
import types

import numpy as np
import pytest
import torch

from cl4wsis_tpu.cl import tasks as jax_tasks
from cl4wsis_tpu.data import loader as jax_loader
from cl4wsis_tpu.data import voc as jax_voc
from cl4wsis_tpu_torch.data import loader, voc
from cl4wsis_tpu_torch.train.trainer import Trainer
from tests.test_data import _write_fake_voc
from torch_one_thread import one_torch_thread  # noqa: F401

SEED = 7


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(port train, JAX train, port val, JAX val) on a painted mini-VOC of
    12 images, VOC 15-5 step 1, 48^2 crops."""
    root = str(tmp_path_factory.mktemp("voc"))
    _write_fake_voc(root, n_images=12, size=64, rich=True, paint=True)
    sd = jax_tasks.get_task_dict("voc", "15-5", 1)
    kw = dict(crop_size=48, crop_size_val=48, seed=SEED)
    pt, pv = voc.make_voc_datasets(root, sd, 1, **kw)
    jt, jv = jax_voc.make_voc_datasets(root, sd, 1, **kw)
    return pt, jt, pv, jv


def assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"image", "seg", "inst", "l1h"}
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert g[k].numpy().dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)


def _children():
    return set(multiprocessing.active_children())


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_matches_jax_over_epochs(datasets, workers):
    """One port loader, its workers persistent, over epochs 0, 1 and 0
    again: each epoch equals the JAX loader's, and epoch 1 draws other
    augmentations than epoch 0 (a worker that kept epoch 0 would repeat
    them). close() stops the workers; the next epoch starts new ones."""
    pt, jt, _, _ = datasets
    before = _children()
    port = loader.Loader(pt, batch_size=4, seed=SEED, num_workers=workers)
    ref = jax_loader.Loader(jt, batch_size=4, seed=SEED, num_workers=2)
    assert len(port) == len(ref) == 3
    seen = {}
    for epoch in (0, 1, 0):
        got = list(port.epoch(epoch))
        assert_same_batches(got, list(ref.epoch(epoch)))
        seen.setdefault(epoch, got)
    assert not torch.equal(seen[0][0]["image"], seen[1][0]["image"])
    if workers:
        ctx = port._loader.multiprocessing_context
        assert ctx.get_start_method() == "forkserver"
        assert port._loader.persistent_workers
    assert len(_children() - before) == workers
    port.close()                  # the workers stop; a later epoch restarts
    deadline = time.time() + 10
    while _children() - before and time.time() < deadline:
        time.sleep(0.1)
    assert not _children() - before
    assert_same_batches(list(port.epoch(1)), list(ref.epoch(1)))
    port.close()


@pytest.mark.parametrize("rank", [0, 1])
def test_loader_rank_shards_match_jax(datasets, rank):
    pt, jt, _, _ = datasets
    kw = dict(batch_size=2, seed=SEED, process_index=rank, process_count=2)
    port = loader.Loader(pt, num_workers=0, **kw)
    ref = jax_loader.Loader(jt, num_workers=1, **kw)
    assert len(port) == len(ref) == 3
    for epoch in (0, 1):
        assert_same_batches(list(port.epoch(epoch)), list(ref.epoch(epoch)))


@pytest.mark.parametrize("n,bs,count", [
    (12, 4, 1), (13, 4, 1), (15, 4, 1), (11, 3, 2), (14, 3, 2), (3, 4, 1),
    (4, 4, 1), (9, 2, 4)])
def test_loader_len_and_order_match_jax(n, bs, count):
    """len() and the (epoch, index) batches against the indices the JAX
    loader (drop_last, as the port always is) hands its dataset, for every
    rank."""
    class Recording:
        def __init__(self):
            self.asked = []

        def __len__(self):
            return n

        def __getitem__(self, key):
            self.asked.append(key)
            return {"x": np.zeros(1)}

    for rank in range(count):
        kw = dict(batch_size=bs, seed=3, process_index=rank,
                  process_count=count)
        ref_ds = Recording()
        ref = jax_loader.Loader(ref_ds, num_workers=1, drop_last=True, **kw)
        port = loader.EpochBatchSampler(n, bs, 3, rank, count)
        assert len(loader.Loader(Recording(), num_workers=0, **kw)) == \
            len(port) == len(ref)
        for epoch in (0, 2):
            n_batches = len(list(ref.epoch(epoch)))
            port.epoch = epoch
            batches = list(port)
            assert len(batches) == n_batches
            assert [i for b in batches for i in b] == [
                (epoch, i) for i in ref_ds.asked]
            ref_ds.asked.clear()


def test_grain_flag_loader_matches_jax_grain_loader(datasets):
    """Under --grain the port uses the same loader; per epoch it gives the
    samples JAX's GrainLoader gives (grain shuffles with its own generator,
    so the order differs)."""
    pytest.importorskip("grain")
    from cl4wsis_tpu.data.grain_pipeline import GrainLoader
    pt, jt, _, _ = datasets

    def digests(batches):
        return sorted(hashlib.sha256(
            np.asarray(b["image"][i]).tobytes()
            + np.asarray(b["seg"][i]).tobytes()
            + np.asarray(b["inst"][i]).tobytes()
            + np.asarray(b["l1h"][i]).tobytes()).hexdigest()
            for b in batches for i in range(len(b["image"])))

    port = loader.Loader(pt, batch_size=4, seed=SEED, num_workers=2)
    ref = GrainLoader(jt, batch_size=4, seed=SEED)
    assert len(port) == len(ref)
    d0 = digests(port.epoch(0))
    assert d0 == digests(ref.epoch(0))
    d1 = digests(port.epoch(1))
    port.close()
    assert d1 == digests(ref.epoch(1)) and d1 != d0


def test_eval_samples_match_jax(datasets):
    _, _, pv, jv = datasets
    for rank, count in ((0, 1), (1, 3)):
        got = list(loader.eval_samples(pv, rank, count))
        want = list(jax_loader.eval_samples(jv, rank, count))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            assert g.pop("fname") == w.pop("fname")
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["gt_masks"].ndim == 3 and got[0]["image"].shape[0] == 1


def _trainer_like(phase):
    return types.SimpleNamespace(cfg=types.SimpleNamespace(phase=phase),
                                 supervised_pseudo=False,
                                 device=torch.device("cpu"))


@pytest.mark.parametrize("phase", [None, 2])
def test_device_batch_takes_loader_tensors_without_a_copy(datasets, phase):
    """Trainer._device_batch keeps the loader's CPU tensors (the same
    storage); numpy batches of other dtypes (the synthetic loader's) are
    converted."""
    pt = datasets[0]
    batch = next(iter(loader.Loader(pt, batch_size=4, seed=SEED,
                                    num_workers=0).epoch(0)))
    got = Trainer._device_batch(_trainer_like(phase), batch)
    keys = {"image", "l1h"} if phase == 2 else {"image", "seg", "inst"}
    assert got.keys() == keys
    for k in keys:
        assert got[k].data_ptr() == batch[k].data_ptr(), k
    npb = {k: v.numpy().astype(np.float64 if k in ("image", "l1h")
                               else np.int64) for k, v in batch.items()}
    conv = Trainer._device_batch(_trainer_like(phase), npb)
    for k in keys:
        assert conv[k].dtype == batch[k].dtype
        assert torch.equal(conv[k], batch[k]), k
