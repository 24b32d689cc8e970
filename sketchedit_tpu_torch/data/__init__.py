"""Dataset registry and a prefetching batch loader (counterpart of
``sketchedit_tpu/data/__init__.py``) for ``dataset_mode`` ``testimage``,
``editimage`` (training) and ``base`` (no dataset).

Batches are numpy NHWC. ``collate`` is a copy of the JAX package's
``_collate``: the last partial batch is padded with repeats of its last
sample and flagged by ``valid``; items in the compact protocol (uint8
``image_u8`` and bool masks, as ``EditImageDataset`` gives them) are
expanded to float32 unless ``compact``, in which case the batch keeps the
uint8 image as ``image`` and the bool masks, and the trainer expands them
on the device. ``DataLoader`` is the JAX loader: the same order (shuffled
from ``seed + epoch``), the same items and the same worker paths (a
prefetch thread, a spawned process pool). This package imports no torch,
so its items need only numpy, PIL and OpenCV and a worker never
initializes CUDA. A spawned worker does import the parent's main module
again, and with it torch where that module imports it (as
``python -m sketchedit_tpu_torch.cli.train`` does).
"""

from __future__ import annotations

import concurrent.futures as _futures
import contextlib
import itertools
import multiprocessing as _mp
import os
import signal
import threading

import numpy as np

from sketchedit_tpu_torch.data.editimage import EditImageDataset
from sketchedit_tpu_torch.data.testimage import TestImageDataset


class BaseDataset:
    """No-op dataset for entry points that read none."""

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def initialize(self, opt):
        self.opt = opt

    def __len__(self):
        return 0


DATASETS = {"testimage": TestImageDataset, "editimage": EditImageDataset,
            "base": BaseDataset}


def find_dataset_using_name(name: str):
    try:
        return DATASETS[name.lower().replace('_', '')]
    except KeyError:
        raise ValueError(f"unknown dataset_mode '{name}'; the port has "
                         f"{sorted(DATASETS)}") from None


def get_option_setter(name: str):
    return find_dataset_using_name(name).modify_commandline_options


def collate(samples, batch_size: int, compact: bool = False):
    """Stack samples, padding to ``batch_size`` with the last one; expand
    the compact protocol unless ``compact``."""
    n = len(samples)
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            vals = vals + [vals[-1]] * (batch_size - n)
            stacked = np.stack(vals)
            if stacked.dtype == bool and not compact:
                stacked = stacked.astype(np.float32)
            batch[key] = stacked
        else:
            batch[key] = list(vals)
    if 'image_u8' in batch:
        if compact:
            batch['image'] = batch.pop('image_u8')
        else:
            img = batch.pop('image_u8').astype(np.float32) / 127.5 - 1.0
            batch['image'] = img
            batch['gt'] = img
    batch['valid'] = n
    return batch


def _one_opencv_thread():
    """Items call OpenCV (Canny, dilate, filter2D) on 256^2 arrays, where
    its thread pool gains no wall time while its threads spin between
    calls, taking cores from the other readers and from the training
    process (PERF.md §5); the loader keeps OpenCV to one thread."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return
    cv2.setNumThreads(1)


# --- spawned-worker plumbing (module level: a fresh interpreter imports it)

_WORKER_STATE: dict = {}


def _worker_init(dataset, base_seed, n_workers=1):
    _one_opencv_thread()
    # a dataset's decode-cache cap (--decode_cache_mb) is a total budget:
    # chunks go to workers by position, not by index, so every worker
    # eventually sees every item, and an undivided cap per process would
    # multiply the loader's memory by the worker count
    if n_workers > 1 and getattr(dataset, "_cache_cap", 0):
        dataset._cache_cap //= n_workers
    _WORKER_STATE["ds"] = dataset
    _WORKER_STATE["seed"] = base_seed


_STOP_SIGNALS = (signal.SIGINT, signal.SIGTERM)


def _pool_worker_init(*args):
    """A pool worker's initializer: ``_worker_init`` in a process that
    leaves SIGINT and SIGTERM to the trainer. A worker shares the trainer's
    process group, so a Ctrl-C in the terminal or a scheduler's signal to
    the group reaches it too; the trainer's handler alone decides when to
    stop (it checkpoints after the step in flight, whose successor may
    already wait on the pool), and ``DataLoader.close`` ends the workers.
    The worker starts with both signals blocked (``_stop_signals_blocked``)
    and keeps them so; a thread takes each one and drops it, except a
    SIGTERM from the trainer (how the pool ends its workers once one of
    them has died) or any SIGTERM once the trainer is gone."""
    signal.pthread_sigmask(signal.SIG_BLOCK, _STOP_SIGNALS)
    threading.Thread(target=_drop_stop_signals, args=(os.getppid(),),
                     daemon=True).start()
    _worker_init(*args)


def _drop_stop_signals(trainer: int):
    while True:
        info = signal.sigwaitinfo(_STOP_SIGNALS)
        if info.si_signo == signal.SIGTERM and (
                info.si_pid == trainer or os.getppid() != trainer):
            os._exit(128 + signal.SIGTERM)


@contextlib.contextmanager
def _stop_signals_blocked():
    """Block SIGINT and SIGTERM in this thread for the block: a worker that
    the pool spawns from it starts with them blocked."""
    saved = signal.pthread_sigmask(signal.SIG_BLOCK, _STOP_SIGNALS)
    try:
        yield
    finally:
        signal.pthread_sigmask(signal.SIG_SETMASK, saved)


def _worker_get(args):
    idx, epoch = args
    ds = _WORKER_STATE["ds"]
    if hasattr(ds, "reseed"):
        ds.reseed((_WORKER_STATE["seed"], epoch, idx))
    return ds[idx]


def _worker_get_chunk(args):
    idxs, epoch = args
    return [_worker_get((i, epoch)) for i in idxs]


class DataLoader:
    """Ordered or shuffled batches. Each pass over it is one epoch;
    shuffling draws the order from ``seed + epoch``.

    ``num_workers`` 0 reads in the caller's thread. 1, or more on a
    single-core host, prefetches 2 batches on one background thread (the
    numpy glue holds the interpreter lock, so more threads only contend);
    the items are those of the serial path. More on a multi-core host (or
    with ``SKETCHEDIT_FORCE_PROCESS_WORKERS=1``) uses a persistent pool of
    spawned processes that prefetches 3 batches, each batch split in chunks
    across the workers and each item drawn after ``reseed((seed, epoch,
    index))``, so a batch does not depend on the worker count. Spawn, not
    fork: the training process holds a CUDA context. A failed read raises
    in the caller. Every path reads with OpenCV on one thread, which for
    the serial and thread paths sets it so in the caller's process.

    With ``world`` > 1 the loader is one rank's of a data-parallel run:
    ``batch_size`` is the global batch, the order is the same on every
    rank, and each batch holds this rank's ``batch_size // world`` rows of
    it (rank r the r-th slice; the remainder batch is dropped, as
    ``drop_last`` must then be). Every path then reseeds each item from
    (seed, epoch, index), as the pool does, so an item does not depend on
    which rank reads it: the ranks' rows together are the batch that a
    single process reads through the pool.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 0, drop_last: bool = False, seed: int = 0,
                 compact: bool = False, rank: int = 0, world: int = 1):
        if world > 1 and (batch_size % world or not drop_last):
            raise ValueError(f"a rank's loader needs drop_last and a batch "
                             f"({batch_size}) that divides over {world} "
                             "ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.compact = compact
        self.rank = rank
        self.world = world
        self._epoch = 0
        self._pool = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def close(self):
        """Stop the worker processes, if any were started."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            if self.drop_last and len(idx) < bs:
                return
            if self.world > 1:
                rows = bs // self.world
                idx = idx[self.rank * rows:(self.rank + 1) * rows]
            yield idx

    def _collate(self, samples):
        return collate(samples, self.batch_size // self.world, self.compact)

    def _item(self, index, epoch):
        """Item ``index``; a rank's loader reseeds it from (seed, epoch,
        index) first, as a pool worker does."""
        if self.world > 1 and hasattr(self.dataset, "reseed"):
            self.dataset.reseed((self.seed, epoch, index))
        return self.dataset[index]

    @property
    def mode(self) -> str:
        """'serial', 'thread' or 'processes': the path ``__iter__`` takes."""
        if self.num_workers == 0:
            return "serial"
        force = os.environ.get("SKETCHEDIT_FORCE_PROCESS_WORKERS") == "1"
        if self.num_workers > 1 and ((os.cpu_count() or 1) > 1 or force):
            return "processes"
        return "thread"

    def __iter__(self):
        self._epoch += 1
        _one_opencv_thread()
        mode = self.mode
        epoch = self._epoch
        if mode == "serial":
            for idx in self._index_batches():
                yield self._collate([self._item(i, epoch) for i in idx])
            return
        if mode == "processes":
            yield from self._iter_processes()
            return

        def read(idx):
            return [self._item(i, epoch) for i in idx]

        with _futures.ThreadPoolExecutor(1) as pool:
            batches = self._index_batches()
            inflight = [pool.submit(read, idx)
                        for idx in itertools.islice(batches, 2)]
            for nxt in batches:
                current = inflight.pop(0)
                inflight.append(pool.submit(read, nxt))
                yield self._collate(current.result())
            for current in inflight:
                yield self._collate(current.result())

    def _iter_processes(self):
        if self._pool is None:
            self._pool = _futures.ProcessPoolExecutor(
                self.num_workers, mp_context=_mp.get_context("spawn"),
                initializer=_pool_worker_init,
                initargs=(self.dataset, self.seed, self.num_workers))
        pool, epoch = self._pool, self._epoch

        def submit(idx):
            # a batch in chunks across the workers: fewer, larger messages;
            # a submit may spawn a worker
            chunks = np.array_split(np.asarray(idx, int), self.num_workers)
            with _stop_signals_blocked():
                return [pool.submit(_worker_get_chunk, (c.tolist(), epoch))
                        for c in chunks if len(c)]

        def gather(futs):
            return self._collate([s for f in futs for s in f.result()])

        batches = self._index_batches()
        inflight = [submit(idx) for idx in itertools.islice(batches, 3)]
        for nxt in batches:
            current = inflight.pop(0)
            inflight.append(submit(nxt))
            yield gather(current)
        for current in inflight:
            yield gather(current)


def create_dataloader(opt, rank: int = 0, world: int = 1):
    """The loader of ``opt.dataset_mode``; ``rank`` and ``world`` make it
    one rank's of a data-parallel run (``DataLoader``)."""
    cls = find_dataset_using_name(opt.dataset_mode)
    instance = cls()
    instance.initialize(opt)
    print(f"dataset [{type(instance).__name__}] of size {len(instance)} "
          "was created")
    train = bool(getattr(opt, 'isTrain', False))
    return DataLoader(instance, batch_size=opt.batchSize,
                      shuffle=not opt.serial_batches,
                      num_workers=int(opt.nThreads), drop_last=train,
                      compact=train, rank=rank, world=world)


def create_dataloader_trainval(opt):
    """Train and val loaders over ``--dataset_mode_train`` and
    ``--dataset_mode_val``: the train loader shuffles (unless
    --serial_batches) and drops the remainder, the val loader keeps the
    order and pads its last batch."""
    assert opt.isTrain
    loaders = []
    for mode, shuffle, drop in ((opt.dataset_mode_train,
                                 not opt.serial_batches, True),
                                (opt.dataset_mode_val, False, False)):
        instance = find_dataset_using_name(mode)()
        instance.initialize(opt)
        loaders.append(DataLoader(instance, batch_size=opt.batchSize,
                                  shuffle=shuffle,
                                  num_workers=int(opt.nThreads),
                                  drop_last=drop))
    return tuple(loaders)
