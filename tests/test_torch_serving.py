"""The port's serving modules on the CPU.

The numpy/PIL modules (``rawproto``, ``letterbox``, ``composite``,
``face_localizer``) are copies of the JAX package's: the same arrays go
through both and the results must be identical (tolerance 0). The
``BatchingExecutor`` is held to the cases of tests/test_executor.py, and the
slice as a whole (concurrent submits through the port's executor on the
port's ``EditPipeline``) to the JAX executor on the JAX pipeline with the
same weights, uint8 within 1 LSB (a rounding boundary may fall between the
two float32 results).
"""

import queue
import threading
import time
from concurrent.futures import Future
from functools import partial

import numpy as np
import pytest
import torch
from PIL import Image

from sketchedit_tpu.models import editline2 as j_e
from sketchedit_tpu.runner import EditPipeline as JaxEditPipeline
from sketchedit_tpu.server import composite as j_composite
from sketchedit_tpu.server import face_localizer as j_localizer
from sketchedit_tpu.server import letterbox as j_letterbox
from sketchedit_tpu.server import rawproto as j_rawproto
from sketchedit_tpu.server.executor import BatchingExecutor as JaxExecutor
from sketchedit_tpu_torch.models.editline2 import EditLine2Config
from sketchedit_tpu_torch.runner import EditPipeline
from sketchedit_tpu_torch.server import composite, face_localizer, letterbox
from sketchedit_tpu_torch.server import rawproto
from sketchedit_tpu_torch.server.executor import (
    _BUCKETS, BatchingExecutor, _bucket, _RingStat)
from test_torch_edit import jax_params, port_model   # scaled kaiming weights



# -- copies: identical results ---------------------------------------------

def _u8_pair(seed, h, w):
    rs = np.random.RandomState(seed)
    return ((rs.rand(h, w, 3) * 255).astype(np.uint8),
            ((rs.rand(h, w) > 0.9) * 255).astype(np.uint8))


@pytest.mark.parametrize("h,w", [(8, 8), (16, 24), (90, 160)])
def test_rawproto_bytes_identical(h, w):
    img, sk = _u8_pair(h + w, h, w)
    body = rawproto.encode(img, sk)
    assert body == j_rawproto.encode(img, sk)
    assert rawproto.HEADER.size == j_rawproto.HEADER.size == 10
    for got, want in zip(rawproto.decode(body), j_rawproto.decode(body)):
        np.testing.assert_array_equal(got, want)
    bulk = body + rawproto.encode(*_u8_pair(1, 8, 12))
    got, want = rawproto.decode_frames(bulk), j_rawproto.decode_frames(bulk)
    assert len(got) == len(want) == 2
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("body", [
    b"", b"NOPE" + b"\x01\x00" + b"\x40\x00" * 2,
    b"SKED" + b"\x09\x00" + b"\x40\x00" * 2,
    b"SKED" + b"\x01\x00" + b"\x40\x00\x40\x00" + b"x" * 7,
], ids=["empty", "magic", "version", "short"])
def test_rawproto_rejects_what_the_jax_copy_rejects(body):
    with pytest.raises(j_rawproto.RawProtoError):
        j_rawproto.decode_frames(body)
    with pytest.raises(rawproto.RawProtoError):
        rawproto.decode_frames(body)


def test_rawproto_frame_limits():
    frame = rawproto.encode(*_u8_pair(2, 8, 8))
    with pytest.raises(rawproto.RawProtoError):
        rawproto.decode(frame * 2)
    with pytest.raises(rawproto.RawProtoError):
        rawproto.decode_frames(frame * 3, max_frames=2)
    with pytest.raises(rawproto.RawProtoError):
        rawproto.decode_frames(frame + b"SKE")


@pytest.mark.parametrize("h,w,size", [(90, 160, 64), (160, 90, 64),
                                      (64, 64, 64), (30, 31, 32),
                                      (300, 20, 256)])
def test_letterbox_identical(h, w, size):
    img, sk = _u8_pair(h * w, h, w)
    args = (Image.fromarray(img), Image.fromarray(sk), size)
    got = letterbox.letterbox_fit(*args)
    want = j_letterbox.letterbox_fit(*args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[0].shape == (size, size, 3)
    rs = np.random.RandomState(size)
    composed = (rs.rand(size, size, 3) * 255).astype(np.uint8)
    mask = (rs.rand(size, size, 1) * 255).astype(np.uint8)
    g = letterbox.letterbox_restore(composed, mask, got[2], (w, h))
    j = j_letterbox.letterbox_restore(composed, mask, want[2], (w, h))
    for a, b in zip(g, j):
        assert a.size == b.size == (w, h)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class HalvingPipeline:
    """Stands in for the model on float batches."""

    def __call__(self, image, sketch):
        return image * 0.5, np.zeros(image.shape[:3] + (1,), np.float32)


def _scene(seed, h=128, w=128):
    rs = np.random.RandomState(seed)
    image = (rs.rand(h, w, 3).astype(np.float32) - 0.5) * 2
    sketch = np.zeros((h, w, 1), np.float32)
    sketch[30:50, 40:60] = 1.0
    return image, sketch


@pytest.mark.parametrize("use_cv2", [True, False], ids=["cv2", "no_cv2"])
def test_composite_identical(monkeypatch, use_cv2):
    if not use_cv2:
        monkeypatch.setattr(composite, "cv2", None)
        monkeypatch.setattr(j_composite, "cv2", None)
    elif composite.cv2 is None:
        pytest.skip("OpenCV is not installed")
    image, sketch = _scene(0)
    u8 = ((image + 1) / 2 * 255).astype(np.uint8)
    assert (composite.localize_edit_region(u8, sketch)
            == j_composite.localize_edit_region(u8, sketch))
    np.testing.assert_array_equal(composite._feather_mask(64),
                                  j_composite._feather_mask(64))
    det = lambda im: [(30, 20, 40, 40), (90, 90, 20, 20)]     # noqa: E731
    for detector in (None, det):
        got = composite.face_crop_edit(HalvingPipeline(), image, sketch,
                                       detector=detector)
        want = j_composite.face_crop_edit(HalvingPipeline(), image, sketch,
                                          detector=detector)
        np.testing.assert_array_equal(got, want)
    # the sketched region was edited, a far corner passes through
    assert np.abs(got[38:42, 48:52]).mean() < np.abs(image[38:42, 48:52]).mean()
    np.testing.assert_allclose(got[120:, 120:], image[120:, 120:])
    blank = np.zeros_like(sketch)
    np.testing.assert_array_equal(
        composite.face_crop_edit(HalvingPipeline(), image, blank),
        j_composite.face_crop_edit(HalvingPipeline(), image, blank))


def test_face_localizer_identical(monkeypatch):
    """No release faces are in the repository, so both copies get the same
    synthetic 32x32 template; a scene with that pattern pasted at two scales
    must give the same boxes from both."""
    if face_localizer.cv2 is None:
        pytest.skip("OpenCV is not installed")
    import cv2
    rs = np.random.RandomState(5)
    yy, xx = np.mgrid[0:32, 0:32]
    tmpl = (np.exp(-((yy - 16) ** 2 + (xx - 16) ** 2) / 60.0) * 200
            + rs.rand(32, 32) * 30).astype(np.float32)
    tmpl[10:13, 8:13] = 20      # "eyes" and a "mouth": structure to match
    tmpl[10:13, 19:24] = 20
    tmpl[22:25, 11:21] = 40
    for mod in (face_localizer, j_localizer):
        monkeypatch.setattr(mod, "_template_cache", {32: tmpl.copy()})
    scene = np.tile(np.linspace(60, 180, 256, dtype=np.uint8)[None, :, None],
                    (320, 1, 3))
    scene = (scene + rs.randint(0, 20, scene.shape)).astype(np.uint8)
    for px, (x0, y0) in ((72, (92, 60)), (48, (20, 220))):
        face = cv2.resize(np.clip(tmpl, 0, 255).astype(np.uint8), (px, px))
        scene[y0:y0 + px, x0:x0 + px] = face[:, :, None]
    got, want = face_localizer.detect(scene), j_localizer.detect(scene)
    assert got == want and got, got
    assert max(face_localizer._iou(b, (92, 60, 72, 72)) for b in got) >= 0.5
    assert face_localizer._iou(got[0], (0, 0, 5, 5)) == j_localizer._iou(
        want[0], (0, 0, 5, 5))
    monkeypatch.setattr(face_localizer, "cv2", None)
    assert face_localizer.detect(scene) == []


# -- the executor: the cases of tests/test_executor.py ----------------------

class RecordingPipeline:
    def __init__(self):
        self.batch_sizes = []
        self.threads = set()
        self.lock = threading.Lock()

    def __call__(self, images, sketches):
        with self.lock:
            self.batch_sizes.append(images.shape[0])
            self.threads.add(threading.current_thread().name)
        time.sleep(0.01)
        return images * 2, sketches


def _f32(value, s=4):
    return (np.full((s, s, 3), value, np.float32),
            np.zeros((s, s, 1), np.float32))


@pytest.mark.parametrize("n,max_batch,want", [
    (1, 64, 1), (3, 64, 8), (33, 64, 64), (200, 64, 64), (9, 128, 32),
    (2, 2, 2), (100, 128, 128)])
def test_bucket_rounding(n, max_batch, want):
    assert _BUCKETS == (1, 8, 32, 128)
    assert _bucket(n, max_batch) == want


def test_ring_stat_percentiles():
    ring = _RingStat(4)
    assert ring.percentiles() == {"p50": None, "p95": None, "p99": None}
    for v in (1, 2, 3, 4, 100, 200):        # wraps: holds 100, 200, 3, 4
        ring.add(float(v))
    assert ring.percentiles() == {"p50": 100.0, "p95": 200.0, "p99": 200.0}


def test_executor_coalesces_scatters_and_counts():
    pipe = RecordingPipeline()
    ex = BatchingExecutor(pipe, max_batch=8, max_wait_ms=30)
    try:
        imgs = [_f32(i)[0] for i in range(6)]
        futs = [ex.submit(i, _f32(0)[1]) for i in imgs]
        for img, fut in zip(imgs, futs):
            np.testing.assert_array_equal(fut.result(timeout=10)[0], img * 2)
        assert sum(pipe.batch_sizes) >= 6 and len(pipe.batch_sizes) < 6
        assert len(pipe.threads) == 1        # the dispatcher thread alone
        for _ in range(100):                 # counters land after set_result
            stats = ex.stats()
            if stats["requests_served"] == 6:
                break
            time.sleep(0.02)
        assert stats["requests_served"] == 6 and stats["batch_errors"] == 0
        assert stats["batches_dispatched"] == len(pipe.batch_sizes)
        assert (sum(stats["batch_size_histogram"].values())
                == stats["batches_dispatched"])
        assert set(stats["batch_size_histogram"]) <= {1, 8}
        for key in ("dispatch_ms", "assemble_ms", "scatter_ms"):
            assert stats[key]["p50"] is not None
        assert stats["queue_depth"] == 0
    finally:
        ex.shutdown()


def test_executor_mixed_size_herd():
    pipe = RecordingPipeline()
    ex = BatchingExecutor(pipe, max_batch=8, max_wait_ms=5, max_queue=16)
    results, errors = {}, []

    def worker(tid):
        rs = np.random.RandomState(tid)
        try:
            for j in range(5):
                img, sk = _f32(tid * 100 + j, (4, 8, 16)[rs.randint(3)])
                results[(tid, j)] = (img, ex.submit(img, sk).result(
                    timeout=30)[0])
        except Exception as e:          # noqa: BLE001 - recorded for assert
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert len(results) == 60
        for img, comp in results.values():
            np.testing.assert_array_equal(comp, img * 2)
    finally:
        ex.shutdown()


def test_executor_bounded_queue_backpressure():
    class Blocking:
        def __call__(self, images, sketches):
            time.sleep(1.0)
            return images, sketches

    ex = BatchingExecutor(Blocking(), max_batch=1, max_wait_ms=1, max_queue=2)
    try:
        img, sk = _f32(0)
        ex.submit(img, sk)
        with pytest.raises(queue.Full):
            for _ in range(8):
                ex._q.put((img, sk, Future()), timeout=0.05)
    finally:
        ex.shutdown()


def test_executor_separates_mixed_sizes():
    ex = BatchingExecutor(RecordingPipeline(), max_batch=8, max_wait_ms=20)
    try:
        f1, f2 = ex.submit(*_f32(0, 4)), ex.submit(*_f32(0, 8))
        assert f1.result(timeout=10)[0].shape == (4, 4, 3)
        assert f2.result(timeout=10)[0].shape == (8, 8, 3)
    finally:
        ex.shutdown()


def test_shutdown_fails_parked_and_queued_requests():
    ex = BatchingExecutor(RecordingPipeline(), max_batch=8, max_wait_ms=10)
    ex.shutdown()                       # stop the dispatcher, then inject
    parked, queued = Future(), Future()
    img, sk = _f32(0)
    ex._pending = (img, sk, parked)
    ex._q.put((img, sk, queued))
    ex.shutdown()
    for fut in (parked, queued):
        with pytest.raises(RuntimeError, match="shut down"):
            fut.result(timeout=1)
    with pytest.raises(RuntimeError):
        ex.submit(img, sk)


def test_malformed_request_fails_only_its_batch():
    ex = BatchingExecutor(RecordingPipeline(), max_batch=8, max_wait_ms=100)
    try:
        img = _f32(0)[0]
        futs = [ex.submit(img, np.zeros((4, 4, 1), np.float32)),
                ex.submit(img, np.zeros((5, 5, 1), np.float32))]
        failed = 0
        for f in futs:
            try:
                f.result(timeout=10)
            except ValueError:
                failed += 1
        assert failed >= 1
        good = ex.submit(*_f32(3))
        np.testing.assert_array_equal(good.result(timeout=10)[0],
                                      _f32(3)[0] * 2)
        assert ex.stats()["batch_errors"] >= 1
    finally:
        ex.shutdown()


def test_cancelled_future_does_not_poison_batch():
    release = threading.Event()

    class GatedPipeline(RecordingPipeline):
        def __call__(self, images, sketches):
            release.wait(timeout=10)
            return super().__call__(images, sketches)

    ex = BatchingExecutor(GatedPipeline(), max_batch=8, max_wait_ms=10)
    try:
        imgs = [_f32(i)[0] for i in range(3)]
        futs = [ex.submit(i, _f32(0)[1]) for i in imgs]
        futs[1].cancel()
        release.set()
        for i in (0, 2):
            np.testing.assert_array_equal(futs[i].result(timeout=10)[0],
                                          imgs[i] * 2)
    finally:
        ex.shutdown()


def test_warmup_runs_every_bucket_and_max_batch():
    pipe = RecordingPipeline()
    ex = BatchingExecutor(pipe, max_batch=12, max_wait_ms=200)
    try:
        ex.warmup((8, 8), timeout=30)
        # buckets 1 and 8 and the clamp to max_batch itself
        assert {1, 8, 12} <= set(pipe.batch_sizes), pipe.batch_sizes
    finally:
        ex.shutdown()


# -- the slice as a whole: port executor + pipeline against the JAX ones ----

def test_served_edits_match_the_jax_executor_on_the_jax_pipeline():
    """Six concurrent 64^2 submits, max_batch 2: every caller's composed
    image and mask from the port within 1 LSB of the same request through
    the JAX executor on the JAX pipeline with the same weights."""
    params = jax_params(4)
    port_pipe = EditPipeline(model=port_model(params),
                             config=EditLine2Config(),
                             device=torch.device("cpu"))
    cfg = j_e.EditLine2Config()
    jax_pipe = JaxEditPipeline(
        params=params, config=cfg, edit_fn=partial(j_e.edit, config=cfg),
        edit_u8_fn=partial(j_e.edit_u8, config=cfg))
    rs = np.random.RandomState(4)
    requests = [(rs.randint(0, 256, (64, 64, 3)).astype(np.uint8),
                 ((rs.rand(64, 64, 1) > 0.9) * 255).astype(np.uint8))
                for _ in range(6)]

    def serve_all(executor):
        out = [None] * len(requests)

        def client(i):
            out[i] = executor.submit(*requests[i]).result(timeout=120)
        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(requests))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=150)
            for _ in range(100):
                stats = executor.stats()
                if stats["requests_served"] == len(requests):
                    break
                time.sleep(0.02)
            return out, stats
        finally:
            executor.shutdown()

    got, stats = serve_all(BatchingExecutor(port_pipe, max_batch=2,
                                            max_wait_ms=50))
    want, _ = serve_all(JaxExecutor(jax_pipe, max_batch=2, max_wait_ms=50))
    assert stats["requests_served"] == 6 and stats["batch_errors"] == 0
    assert stats["batches_dispatched"] < 6          # some were coalesced
    worst = 0
    for (img, _), g, w in zip(requests, got, want):
        assert g is not None and w is not None
        assert g[0].dtype == np.uint8 and g[0].shape == (64, 64, 3)
        assert g[1].shape == (64, 64, 1)
        for a, b in zip(g, w):
            worst = max(worst, int(np.abs(a.astype(np.int16)
                                          - np.asarray(b).astype(np.int16)
                                          ).max()))
        assert np.abs(g[0].astype(int) - img).mean() > 5    # a real edit
    assert worst <= 1, f"max uint8 difference {worst}"


def test_served_rows_match_one_by_one_calls():
    """Five concurrent 64^2 submits under max_batch 8 (coalesced batches are
    padded up to their bucket with copies of the last row): every caller's
    result within 1 LSB of the same image through the pipeline alone at
    B = 1, so neither padding nor batching couples the rows of a batch."""
    port_pipe = EditPipeline(model=port_model(jax_params(5)),
                             config=EditLine2Config(),
                             device=torch.device("cpu"))
    rs = np.random.RandomState(5)
    requests = [(rs.randint(0, 256, (64, 64, 3)).astype(np.uint8),
                 ((rs.rand(64, 64, 1) > 0.9) * 255).astype(np.uint8))
                for _ in range(5)]
    alone = [port_pipe(img[None], sk[None]) for img, sk in requests]
    executor = BatchingExecutor(port_pipe, max_batch=8, max_wait_ms=200)
    try:
        futures = [executor.submit(img, sk) for img, sk in requests]
        got = [f.result(timeout=120) for f in futures]
        for _ in range(100):
            stats = executor.stats()
            if stats["requests_served"] == len(requests):
                break
            time.sleep(0.02)
    finally:
        executor.shutdown()
    assert stats["batches_dispatched"] < len(requests)      # coalesced
    assert any(int(b) > 1 for b in stats["batch_size_histogram"])
    worst = max(int(np.abs(g.astype(np.int16) - a[0].astype(np.int16)).max())
                for got_, alone_ in zip(got, alone)
                for g, a in zip(got_, alone_))
    assert worst <= 1, f"max uint8 difference {worst}"
