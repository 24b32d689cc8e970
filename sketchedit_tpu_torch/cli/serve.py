"""Batch-serving HTTP API on the port (counterpart of
``sketchedit_tpu/cli/serve.py``).

POST /edit with a JSON body {"image": <base64 PNG/JPEG>, "sketch":
<base64 PNG>} returns {"image": <base64 PNG of the edit>, "mask":
<base64 PNG of the predicted mask>}. Concurrent requests are dynamically
coalesced into device batches (server/executor.py), which lifts the
throughput of one GPU well above batch-1 dispatch.

POST /edit with Content-Type: application/octet-stream takes the raw
binary protocol instead (server/rawproto.py: 10-byte header + raw uint8
image + sketch planes, same format back) — the machine-to-machine
throughput path with no PNG codec work on the serving host. A body may
concatenate SEVERAL frames (bulk request): all submit to the executor
before the first wait, so one POST becomes one device batch and the
per-request HTTP cost amortizes over N images. Frames already at
--edit_size skip the letterbox resize entirely.

    python -m sketchedit_tpu_torch.cli.serve --name celeb \
        --joint_train_inp --use_cam --pool_type max --dataset_mode base \
        --port 9999 --compute_dtype bfloat16 --precision default

The model runs on the GPU unless --device cpu is given. GET /healthz
answers once every batch bucket is warm; GET /stats reports the HTTP
counters, the raw path's per-stage host times and the executor's.

Deployment hosts can serve from exported programs instead of checkpoints
and model code (scripts/export_serving_artifact_torch.py), on one device:

    python -m sketchedit_tpu_torch.cli.serve --serve_artifact celeb_b1.pt2 \
        --serve_artifact celeb_b32.pt2 --port 9999
"""

import base64
import io
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
from PIL import Image

from sketchedit_tpu_torch.options.test_options import TestOptions

EDIT_SIZE = 256          # default; --edit_size overrides (multiple of 8)
# Default --max_batch: the JAX package's, which no measurement on the card
# gives a reason to leave. chip_smoke.py's time_serving lines on an NVIDIA
# H100 80GB HBM3 at 700 W (256^2, bfloat16, TF32 allowed, in process, a
# 20 ms batching window, two readings each): with 128 concurrent clients
# 414 and 434 img/s (p50 300 and 278 ms) at 32 against 433 and 385 img/s
# (p50 270 and 262 ms) at 128; with 32 clients 402 and 383 img/s (p50 71
# and 69 ms) at 32 against 333 and 351 img/s (p50 90 and 90 ms) at 128,
# where a batch that cannot fill waits out the window.
MAX_BATCH = 128


class ApiOptions(TestOptions):
    def initialize(self, parser):
        parser = TestOptions.initialize(self, parser)
        parser.add_argument('--max_batch', type=int, default=MAX_BATCH)
        parser.add_argument('--edit_size', type=int, default=EDIT_SIZE,
                            help='square working canvas (multiple of '
                                 '8); inputs are letterboxed onto it '
                                 '(aspect preserved) and outputs '
                                 'resize back to the input size')
        parser.add_argument('--max_wait_ms', type=float, default=5.0)
        parser.add_argument('--serve_artifact', action='append',
                            default=None, metavar='PATH',
                            help='serve from exported .pt2 artifacts '
                                 '(scripts/export_serving_artifact_torch.py) '
                                 'instead of checkpoints + model code; '
                                 'repeat for multiple batch sizes (one '
                                 'artifact per batch bucket)')
        # serving default is the throughput configuration (bfloat16
        # activations, TF32 allowed where float32 remains); checkpoint-
        # parity evaluation (cli/infer.py) keeps float32/highest.
        parser.set_defaults(dataset_mode='base',
                            compute_dtype='bfloat16',
                            precision='default')
        return parser


def main():
    opt = ApiOptions().parse()
    edit_size = opt.edit_size
    if edit_size % 8:
        raise SystemExit(f"--edit_size {edit_size} must be a multiple of 8")
    if opt.serve_artifact and (
            opt.attention_impl == "sharded" or len(opt.gpu_ids) > 1
            or opt.data_parallel > 1):
        raise SystemExit("--serve_artifact serves on one device: it takes "
                         "neither --attention_impl sharded nor several "
                         "--gpu_ids or --data_parallel")

    from sketchedit_tpu_torch.server import rawproto
    from sketchedit_tpu_torch.server.executor import BatchingExecutor
    from sketchedit_tpu_torch.server.letterbox import (
        letterbox_fit, letterbox_restore)

    # Fail fast on a dead accelerator: CUDA initialisation, the kernels'
    # build (nvcc, on the first batch) or the first device call can hang,
    # and the first device touch happens inside pipeline construction, so
    # the watchdog is armed before it, not just around warmup. A server
    # that never binds its port is worse for an orchestrator than one that
    # exits nonzero: supervisors restart on exit, not on silence.
    # SERVE_WARMUP_WATCHDOG_S=0 disables.
    wd_s = float(os.environ.get("SERVE_WARMUP_WATCHDOG_S", 2400))

    def _warmup_abort():
        print(f"warmup watchdog: device init, kernel build or warmup still "
              f"hung after {wd_s:.0f}s; exiting", file=sys.stderr, flush=True)
        os._exit(3)
    wd = None
    if wd_s > 0:
        wd = threading.Timer(wd_s, _warmup_abort)
        wd.daemon = True
        wd.start()

    if opt.serve_artifact:
        from sketchedit_tpu_torch.device import resolve_device
        from sketchedit_tpu_torch.server.artifact import ArtifactPipeline
        device = resolve_device(opt.device)
        pipeline = ArtifactPipeline(opt.serve_artifact)
        if pipeline.device.type != device.type:
            raise SystemExit(f"the artifacts run on {pipeline.device}, "
                             f"not on --device {opt.device}")
        if pipeline.size != edit_size:
            print(f"NOTE: --edit_size {edit_size} -> {pipeline.size} "
                  "(the artifacts' exported size)")
            edit_size = pipeline.size
        if pipeline.max_batch < opt.max_batch:
            opt.max_batch = pipeline.max_batch
        print(f"serving from {len(opt.serve_artifact)} artifact(s), "
              f"batch buckets {pipeline.batches}, size {edit_size}")
    else:
        from sketchedit_tpu_torch.runner import build_pipeline
        pipeline = build_pipeline(opt)
    executor = BatchingExecutor(pipeline, max_batch=opt.max_batch,
                                max_wait_ms=opt.max_wait_ms)
    print("warming batch buckets (kernel build, then one batch per "
          "bucket size)...")
    executor.warmup((edit_size, edit_size))
    if wd is not None:
        wd.cancel()
    print("warmup done")

    MAX_BODY = 64 * 1024 * 1024          # 2x a 4096^2 PNG pair, generous
    started_at = time.time()
    http_counts = {"ok": 0, "client_error": 0, "server_error": 0}
    http_lock = threading.Lock()

    # per-stage host-time accounting for the raw (octet-stream) path —
    # GET /stats reports it so "where do the ms/frame go" is observable
    # on a live loaded server instead of guessed. wait_ms includes
    # the device step + batching delay; every other stage is host CPU on
    # the handler thread.
    raw_lock = threading.Lock()
    raw_stages = {"bodies": 0, "frames": 0, "read_ms": 0.0,
                  "decode_ms": 0.0, "letterbox_ms": 0.0, "submit_ms": 0.0,
                  "wait_ms": 0.0, "to_u8_ms": 0.0, "encode_ms": 0.0,
                  "write_ms": 0.0}

    def _racc(**kw):
        with raw_lock:
            for k, v in kw.items():
                raw_stages[k] += v

    def _count(kind):
        with http_lock:
            http_counts[kind] += 1

    class Handler(BaseHTTPRequestHandler):
        # socket timeout: a client that sends fewer bytes than its
        # Content-Length must not hang a handler thread forever
        timeout = 120

        def log_message(self, *a):
            pass

        def do_GET(self):
            # ops endpoints: the server binds only after warmup, so a
            # 200 from /healthz means "warm and serving" (readiness
            # == liveness here)
            if self.path == "/healthz":
                body = b"ok"
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
            elif self.path == "/stats":
                with http_lock:
                    counts = dict(http_counts)
                with raw_lock:
                    rs = dict(raw_stages)
                nf = max(rs["frames"], 1)
                raw_report = {
                    "totals": {k: (round(v, 1) if isinstance(v, float)
                                   else v) for k, v in rs.items()},
                    "per_frame_ms": {
                        k[:-3]: round(v / nf, 3) for k, v in rs.items()
                        if k.endswith("_ms")},
                    "host_ms_per_frame_excl_wait": round(
                        sum(v for k, v in rs.items()
                            if k.endswith("_ms") and k != "wait_ms") / nf,
                        3),
                }
                body = json.dumps({
                    "uptime_s": round(time.time() - started_at, 1),
                    "edit_size": edit_size,
                    "max_batch": opt.max_batch,
                    "http": counts,
                    "raw_path_stages": raw_report,
                    "executor": executor.stats(),
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
            else:
                self.send_error(404)
                return
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        @staticmethod
        def _to_u8(composed, mask):
            composed = np.asarray(composed)
            mask = np.asarray(mask)
            if composed.dtype != np.uint8:
                composed = ((np.clip(composed.astype(np.float32), -1, 1)
                             + 1) * 127.5).astype(np.uint8)
                mask = (np.clip(mask.astype(np.float32), 0, 1)
                        * 255).astype(np.uint8)
            return composed, mask

        def _finish_edit(self, img_u8, sk_u8, content_wh, out_wh):
            """JSON path: dispatch one edit and reply base64-PNG."""
            composed, mask = self._to_u8(
                *executor.submit(img_u8, sk_u8).result(timeout=120))
            out_img, out_mask = letterbox_restore(
                composed, mask, content_wh, out_wh)

            def b64(im):
                buf = io.BytesIO()
                # compress_level 1: PNG is lossless at any level; the
                # default (6) spends ~4x the zlib CPU for a slightly
                # smaller body — encode time is what bounds the loaded
                # JSON path on the serving host
                im.save(buf, format="PNG", compress_level=1)
                return base64.b64encode(buf.getvalue()).decode()

            body = json.dumps({"image": b64(out_img),
                               "mask": b64(out_mask)}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            # count BEFORE the body write: the response is fully formed
            # here, and a client that has read its body must observe the
            # counter on an immediate /stats (counting after the write
            # races exactly that read — observed on a loaded host)
            _count("ok")
            self.wfile.write(body)

        def _edit_raw(self, body, read_ms=0.0):
            """application/octet-stream: rawproto in/out — no image codec
            on either side (the machine-to-machine throughput path).

            A body may carry SEVERAL concatenated frames (the bulk shape):
            all are submitted to the executor before the first wait, so
            one bulk POST coalesces into one device batch and the
            per-request HTTP/GIL cost is paid once per N images — the
            binding constraint of the loaded single-frame path on a
            small host, where the per-request host work is the wall, not
            the device."""
            t0 = time.perf_counter()
            try:
                frames = rawproto.decode_frames(body)
            except rawproto.RawProtoError as e:
                _count("client_error")
                self.send_error(400, f"bad raw payload: {e}")
                return
            t1 = time.perf_counter()
            pending = []
            lb_ms = sub_ms = 0.0
            for img, sk in frames:
                h, w = img.shape[:2]
                if (h, w) == (edit_size, edit_size):
                    img_u8, sk_u8, content_wh = img, sk, (w, h)
                else:
                    tl = time.perf_counter()
                    img_u8, sk_u8, content_wh = letterbox_fit(
                        Image.fromarray(img), Image.fromarray(sk[:, :, 0]),
                        edit_size)
                    lb_ms += (time.perf_counter() - tl) * 1e3
                ts = time.perf_counter()
                pending.append((executor.submit(img_u8, sk_u8),
                                content_wh, (w, h)))
                sub_ms += (time.perf_counter() - ts) * 1e3
            wait_ms = u8_ms = enc_ms = 0.0
            parts = []
            for fut, content_wh, out_wh in pending:
                tw = time.perf_counter()
                composed, mask = fut.result(timeout=120)
                tu = time.perf_counter()
                composed, mask = self._to_u8(composed, mask)
                te = time.perf_counter()
                if content_wh == out_wh == (edit_size, edit_size):
                    # canvas-native frame: zero-codec, zero-resize
                    parts.append(rawproto.encode(composed, mask))
                else:
                    out_img, out_mask = letterbox_restore(
                        composed, mask, content_wh, out_wh)
                    parts.append(rawproto.encode(
                        np.asarray(out_img.convert("RGB"), np.uint8),
                        np.asarray(out_mask.convert("L"), np.uint8)))
                now = time.perf_counter()
                wait_ms += (tu - tw) * 1e3
                u8_ms += (te - tu) * 1e3
                enc_ms += (now - te) * 1e3
            resp = b"".join(parts)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(resp)))
            self.end_headers()
            # count before the body write (see _finish_edit); the stage
            # ledger still lands after it — write_ms needs the write —
            # so ledger readers poll rather than race one request
            _count("ok")
            t2 = time.perf_counter()
            self.wfile.write(resp)
            t3 = time.perf_counter()
            _racc(bodies=1, frames=len(frames), read_ms=read_ms,
                  decode_ms=(t1 - t0) * 1e3, letterbox_ms=lb_ms,
                  submit_ms=sub_ms, wait_ms=wait_ms, to_u8_ms=u8_ms,
                  encode_ms=enc_ms, write_ms=(t3 - t2) * 1e3)

        def do_POST(self):
            if self.path != "/edit":
                _count("client_error")
                self.send_error(404)
                return
            try:
                # client errors -> 400 with a reason; everything after
                # decode is server-side -> 500. Only body READS and
                # parses live in the inner try: pipeline work (including
                # _edit_raw's dispatch/encode/response) must classify as
                # server-side, else a BrokenPipeError mid-response or an
                # executor ValueError would be reported as the client's
                # fault
                raw_body = None
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length < 0:
                        # a negative length would make rfile.read(-1)
                        # buffer the socket until EOF, bypassing MAX_BODY
                        # and pinning a handler thread
                        _count("client_error")
                        self.send_error(400, "bad Content-Length")
                        return
                    if length > MAX_BODY:
                        _count("client_error")
                        self.send_error(413, "request body too large")
                        return
                    ctype = (self.headers.get("Content-Type") or
                             "").split(";")[0].strip().lower()
                    if ctype == "application/octet-stream":
                        tr = time.perf_counter()
                        raw_body = self.rfile.read(length)
                        read_ms = (time.perf_counter() - tr) * 1e3
                    else:
                        payload = json.loads(self.rfile.read(length))
                        img = Image.open(io.BytesIO(
                            base64.b64decode(
                                payload["image"]))).convert("RGB")
                        sk = Image.open(io.BytesIO(
                            base64.b64decode(
                                payload["sketch"]))).convert("L")
                except (json.JSONDecodeError, KeyError, TypeError,
                        ValueError, OSError) as e:
                    # TypeError covers valid-JSON non-object bodies
                    # ("abc", [1]) and non-string b64 fields
                    _count("client_error")
                    self.send_error(
                        400, f"bad request: {type(e).__name__}: "
                             f"{str(e)[:160]}")
                    return
                if raw_body is not None:
                    self._edit_raw(raw_body, read_ms)
                    return
                w0, h0 = img.size
                # aspect-preserving letterbox onto the shared square
                # canvas: what the model sees is undistorted (like the
                # demo path's /8 rounding, reference demo.py:43-45) while
                # every request keeps ONE spatial shape so the executor
                # still coalesces them into device batches
                img_u8, sk_u8, content_wh = letterbox_fit(
                    img, sk, edit_size)
                self._finish_edit(img_u8, sk_u8, content_wh, (w0, h0))
            except Exception as e:                  # pragma: no cover
                import traceback
                traceback.print_exc()
                _count("server_error")
                try:
                    self.send_error(500, str(e)[:200])
                except OSError:
                    pass        # client already gone (e.g. BrokenPipe)

    class Server(ThreadingHTTPServer):
        request_queue_size = 128        # survive thundering-herd accepts

    server = Server(("0.0.0.0", opt.port), Handler)
    print(f"serve_api listening on :{opt.port} "
          f"(dynamic batching up to {opt.max_batch})")
    try:
        server.serve_forever()
    finally:
        executor.shutdown()


if __name__ == "__main__":
    main()
