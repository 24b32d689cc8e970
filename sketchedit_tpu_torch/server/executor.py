"""Dynamic-batching serving executor (counterpart of
``sketchedit_tpu/server/executor.py``; plain numpy and threads).

One edit leaves the GPU mostly idle: an eager forward is several hundred
small launches, and the host issues them no faster for one image than for
many. This executor turns concurrent callers into device batches:
callers enqueue single edits; a dispatcher thread coalesces them into one
batch (padded to a bucket size), runs the pipeline, and scatters results
back to the callers' futures. The pipeline is called from the dispatcher
thread only.

Usage:
    ex = BatchingExecutor(pipeline, max_batch=64, max_wait_ms=5)
    fut = ex.submit(image_u8, sketch_u8)      # thread-safe
    composed, mask = fut.result()
    ex.shutdown()
"""

from __future__ import annotations

import queue
import threading
import time as _time
from concurrent.futures import Future

import numpy as np

# Coarse buckets, the JAX package's, so /stats histograms stay comparable.
# Nothing is compiled per batch size here (PyTorch runs eagerly), so today a
# bucket buys only what its warm-up buys: cuDNN's algorithm choice and the
# caching allocator's blocks for that shape. A few fixed shapes are what a
# CUDA graph per (batch, size) will need (ROADMAP queue 1 item 8); until
# then the padding is spent work.
_BUCKETS = (1, 8, 32, 128)


def _bucket(n: int, max_batch: int) -> int:
    for b in _BUCKETS:
        if b >= n:
            return min(b, max_batch)
    return max_batch


class _RingStat:
    """Fixed-size sample ring for percentile snapshots (no unbounded
    growth on a long-lived server)."""

    def __init__(self, cap: int):
        self._buf = [0.0] * cap
        self._n = 0
        self._cap = cap

    def add(self, v: float):
        self._buf[self._n % self._cap] = v
        self._n += 1

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        m = min(self._n, self._cap)
        if m == 0:
            return {f"p{q}": None for q in qs}
        s = sorted(self._buf[:m])
        return {f"p{q}": round(s[min(m - 1, int(m * q / 100))], 2)
                for q in qs}


class BatchingExecutor:
    def __init__(self, pipeline, *, max_batch: int = 64,
                 max_wait_ms: float = 5.0, max_queue: int = 1024):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        # bounded: a stalled device backs pressure up to callers (submit
        # raises queue.Full) instead of growing an unbounded request list
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        # dispatcher-private slot for a size-mismatched request pulled out of
        # a batch: putting it back on a bounded queue could deadlock (the
        # dispatcher is the only consumer), so it is carried to the next batch
        self._pending = None
        self._stop = threading.Event()
        # serializes submit's stop-check+enqueue against shutdown's
        # stop-set: nothing can enqueue after _stop is set, so the
        # post-join drain in shutdown() provably sees every unserved item
        self._submit_lock = threading.Lock()
        # serving statistics (GET /stats): guarded by its own lock so the
        # dispatcher never contends with submitters
        self._stats_lock = threading.Lock()
        self._served = 0
        self._batches = 0
        self._batch_errors = 0
        self._batch_hist: dict[int, int] = {}
        self._dispatch_ms = _RingStat(512)
        # host-side batch assembly (np.stack memcpy) and future scatter,
        # separated from the device step so /stats can attribute the
        # dispatcher thread's host CPU (1-core hosts: this contends with
        # every handler thread)
        self._assemble_ms = _RingStat(512)
        self._scatter_ms = _RingStat(512)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def warmup(self, hw: tuple[int, int] = (256, 256), channels: int = 3,
               timeout: float | None = None):
        """Run every reachable bucket size once for one spatial shape
        (including max_batch itself, which _bucket clamps to). The first
        batch builds and loads the CUDA kernels (nvcc, seconds) on the
        dispatcher thread, and each bucket lets cuDNN pick its algorithms
        and the allocator grow to that shape, so no served request pays
        for either.

        timeout bounds each bucket's wait; None waits indefinitely: the
        caller's watchdog (serve: SERVE_WARMUP_WATCHDOG_S) owns the
        deadline."""
        h, w = hw
        sizes = sorted({b for b in _BUCKETS if b <= self.max_batch}
                       | {self.max_batch})
        for b in sizes:
            img = np.zeros((h, w, channels), np.uint8)
            sk = np.zeros((h, w, 1), np.uint8)
            futs = [self.submit(img, sk) for _ in range(b)]
            for f in futs:
                f.result(timeout=timeout)

    def submit(self, image: np.ndarray, sketch: np.ndarray) -> Future:
        """image: (H, W, 3); sketch: (H, W, 1). All requests in flight must
        share one spatial size (the demo's /8 bucketing upstream ensures
        this); mixed sizes are dispatched in separate batches."""
        fut: Future = Future()
        # under the lock: a submit cannot slip its item in after
        # shutdown() set _stop, so every enqueued item is either served
        # by the dispatcher or caught by shutdown's post-join drain.
        # (An unlocked post-put re-check was the previous design; it
        # could set_exception on a future the dispatcher had already
        # pulled into a batch, poisoning the whole batch scatter with
        # InvalidStateError.) Worst case the lock is held for the 30s
        # full-queue timeout, which only delays shutdown, never deadlocks.
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("executor shut down")
            self._q.put((image, sketch, fut), timeout=30.0)
        return fut

    def _collect(self):
        """Block for one request, then drain compatible ones briefly."""
        if self._pending is not None:
            first, self._pending = self._pending, None
        else:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                return []
        items = [first]
        shape = first[0].shape
        # plain deadline timestamp, not a threading.Timer: a Timer is an
        # OS thread created and torn down PER BATCH on the dispatch hot
        # path — measurable overhead on the small serving hosts where
        # per-request host CPU is the throughput wall
        deadline = _time.monotonic() + self.max_wait
        while len(items) < self.max_batch:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt[0].shape != shape:
                # different size: flush current batch, carry this one
                self._pending = nxt
                break
            items.append(nxt)
        return items

    def _loop(self):
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            try:
                # batch assembly is inside the try: one malformed request
                # (e.g. a sketch missing its channel axis, which _collect's
                # image-shape check can't see) must fail only its own batch,
                # never kill the dispatcher thread
                n = len(items)
                b = _bucket(n, self.max_batch)
                ta = _time.perf_counter()
                images = np.stack([it[0] for it in items]
                                  + [items[-1][0]] * (b - n))
                sketches = np.stack([it[1] for it in items]
                                    + [items[-1][1]] * (b - n))
                t0 = _time.perf_counter()
                composed, mask = self.pipeline(images, sketches)
                t1 = _time.perf_counter()
                for i, (_, _, fut) in enumerate(items):
                    try:
                        # returns False iff the caller cancelled; afterwards
                        # the future is RUNNING and set_result cannot race
                        # cancel()
                        if fut.set_running_or_notify_cancel():
                            fut.set_result((composed[i], mask[i]))
                    except Exception:   # already-resolved future: only its
                        pass            # own result is lost, not the batch's
                t2 = _time.perf_counter()
                with self._stats_lock:
                    self._served += n
                    self._batches += 1
                    self._batch_hist[b] = self._batch_hist.get(b, 0) + 1
                    self._dispatch_ms.add((t1 - t0) * 1000.0)
                    self._assemble_ms.add((t0 - ta) * 1000.0)
                    self._scatter_ms.add((t2 - t1) * 1000.0)
            except Exception as e:
                with self._stats_lock:
                    self._batch_errors += 1
                for _, _, fut in items:
                    try:
                        if not fut.done():
                            fut.set_exception(e)
                    except Exception:   # racing cancel(); never kill _loop
                        pass

    def stats(self) -> dict:
        """Snapshot of serving counters (thread-safe, cheap)."""
        with self._stats_lock:
            hist = dict(sorted(self._batch_hist.items()))
            served, batches = self._served, self._batches
            errors = self._batch_errors
            pct = self._dispatch_ms.percentiles()
            asm = self._assemble_ms.percentiles()
            sct = self._scatter_ms.percentiles()
        return {
            "requests_served": served,
            "batches_dispatched": batches,
            "batch_errors": errors,
            "batch_size_histogram": hist,
            "mean_batch_fill": round(served / batches, 2) if batches else None,
            "dispatch_ms": pct,          # device step incl. host<->device
            "assemble_ms": asm,          # np.stack batch build (host memcpy)
            "scatter_ms": sct,           # future fan-out (host)
            "queue_depth": self._q.qsize(),
        }

    def shutdown(self):
        with self._submit_lock:
            self._stop.set()
        self._thread.join(timeout=5)
        # fail anything still queued or parked in _pending so no client
        # blocks on a future that will never resolve
        leftovers = []
        if self._pending is not None:
            leftovers.append(self._pending)
            self._pending = None
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for _, _, fut in leftovers:
            try:
                if not fut.done():
                    fut.set_exception(RuntimeError("executor shut down"))
            except Exception:       # racing cancel(); already resolved
                pass
