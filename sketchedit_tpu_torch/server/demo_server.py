"""Interactive sketch-edit demo server (counterpart of
``sketchedit_tpu/server/demo_server.py``).

Feature-equivalent to the reference Flask demo (demo.py + the canvas
template): draw strokes over an image in the browser, submit, get the
edited image back, edits chain (the result becomes the next input), and an
example-cycling button. Built on the standard library's http.server with
one pipeline behind a lock.

Arbitrary input sizes are handled the reference way — rounded down to a
multiple of 8 (demo.py:43) and capped at max_size 640. PyTorch runs
eagerly, so a new size costs no compile; the first edit of the process
builds the CUDA kernels.
"""

from __future__ import annotations

import base64
import io
import os
import random
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
from PIL import Image

MAX_SIZE = 640

_PAGE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>SketchEdit demo</title>
<style>
 body {{ font-family: sans-serif; margin: 24px; background: #fafafa; }}
 #wrap {{ position: relative; display: inline-block; }}
 #wrap img {{ display: block; }}
 #pad {{ position: absolute; left: 0; top: 0; cursor: crosshair; }}
 button {{ margin: 4px; padding: 6px 14px; }}
 #status {{ color: #666; margin-left: 8px; }}
</style>
</head>
<body>
<h2>SketchEdit — draw a partial sketch, then Edit</h2>
<div id="wrap">
  <img id="im" src="/static/images/{image_name}?v={version}"
       width="{w}" height="{h}">
  <canvas id="pad" width="{w}" height="{h}"></canvas>
</div>
<div>
  <button onclick="submitSketch()">Edit</button>
  <button onclick="clearPad()">Clear strokes</button>
  <button onclick="nextExample()">Next example</button>
  <span id="status"></span>
</div>
<script>
const pad = document.getElementById('pad');
const ctx = pad.getContext('2d');
ctx.strokeStyle = 'rgb(0,0,255)';
ctx.lineWidth = 2;
ctx.lineCap = 'round';
let drawing = false;
function pos(e) {{
  const r = pad.getBoundingClientRect();
  const t = e.touches ? e.touches[0] : e;
  return [t.clientX - r.left, t.clientY - r.top];
}}
function down(e) {{ drawing = true; const [x,y] = pos(e);
  ctx.beginPath(); ctx.moveTo(x, y); e.preventDefault(); }}
function move(e) {{ if (!drawing) return; const [x,y] = pos(e);
  ctx.lineTo(x, y); ctx.stroke(); e.preventDefault(); }}
function up() {{ drawing = false; }}
pad.addEventListener('mousedown', down);
pad.addEventListener('mousemove', move);
window.addEventListener('mouseup', up);
pad.addEventListener('touchstart', down);
pad.addEventListener('touchmove', move);
pad.addEventListener('touchend', up);
function clearPad() {{ ctx.clearRect(0, 0, pad.width, pad.height); }}
function setStatus(s) {{ document.getElementById('status').textContent = s; }}
async function submitSketch() {{
  setStatus('editing…');
  const body = new URLSearchParams();
  body.set('imgname', '{image_name}');
  body.set('im_idx', '{idx}');
  body.set('mask', pad.toDataURL('image/png'));
  const r = await fetch('/', {{method: 'POST', body}});
  if (r.ok) {{ location.href = await r.text(); }}
  else setStatus('error: ' + r.status);
}}
async function nextExample() {{
  const body = new URLSearchParams();
  body.set('changeim', '1');
  body.set('im_idx', '{idx}');
  const r = await fetch('/', {{method: 'POST', body}});
  location.href = await r.text();
}}
</script>
</body>
</html>
"""


# reference demo.py:24 declares (but never enforces) this cap; we enforce it
MAX_NUM_EXAMPLES = 200


def _save_png(image, path: str):
    """Write a PNG so that a concurrent reader sees the old file or the new
    one, never a partial one: write beside it, then rename over it. Handler
    threads render images that other threads' edits are writing (two edits
    can draw the same random result name)."""
    tmp = f"{path}.{threading.get_ident()}.tmp"
    image.save(tmp, format="PNG")
    os.replace(tmp, path)


class DemoApp:
    """Holds the pipeline, the example list and the lock that serializes
    device access."""

    def __init__(self, pipeline, static_root="static", filelist=None,
                 face_crop: bool = False):
        self.pipeline = pipeline
        self.static_root = static_root
        self.face_crop = face_crop
        for sub in ("images", "masks", "results"):
            os.makedirs(os.path.join(static_root, sub), exist_ok=True)
        self.examples = []
        if filelist and os.path.exists(filelist):
            with open(filelist) as f:
                self.examples = [line.strip() for line in f if line.strip()]
        if not self.examples:
            self.examples = sorted(
                n for n in os.listdir(os.path.join(static_root, "images"))
                if n.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
        self.lock = threading.Lock()
        self.version = 0

    # -- core edit ------------------------------------------------------
    def process_image(self, img: Image.Image, sketch: Image.Image,
                      name: str, save_to_input: bool = True) -> str:
        """Resize /8, run the edit, resize back, save & chain."""
        img = img.convert("RGB")
        w_raw, h_raw = img.size
        scale = min(1.0, MAX_SIZE / max(w_raw, h_raw))
        # floor at 16, not 8: extreme aspect ratios must not round a side
        # to 0, and the 4x4/stride-2 attention patch grid needs >= 4 px at
        # the H/4 feature level (an 8-px side yields ZERO patches and the
        # kernel divides by the patch count)
        w_t = max(16, int(w_raw * scale) // 8 * 8)
        h_t = max(16, int(h_raw * scale) // 8 * 8)

        img_r = img.resize((w_t, h_t))
        sk_r = sketch.convert("L").resize((w_t, h_t))

        if self.face_crop:
            from sketchedit_tpu_torch.server.composite import face_crop_edit
            from sketchedit_tpu_torch.server.face_localizer import detect
            image = (np.asarray(img_r, np.float32) / 255.0 - 0.5) / 0.5
            line = (np.asarray(sk_r, np.float32) > 0).astype(np.float32)
            with self.lock:     # serialize device access like the u8 path
                # bundled average-face NCC localizer; the sketch+skin-blob
                # heuristic inside face_crop_edit remains the fallback
                # when it returns no boxes
                result = face_crop_edit(self.pipeline, image,
                                        line[:, :, None], detector=detect)
            result = np.clip(result.astype(np.float32), -1, 1)
            result_u8 = ((result + 1) / 2 * 255).astype(np.uint8)
        else:
            # fused uint8 path: normalization runs on-device
            image_u8 = np.asarray(img_r, np.uint8)
            sk_u8 = np.asarray(sk_r, np.uint8)[:, :, None]
            with self.lock:
                composed, _mask = self.pipeline(image_u8[None],
                                                sk_u8[None])
            result_u8 = np.asarray(composed[0])
            if result_u8.dtype != np.uint8:   # float pipeline (tests)
                result_u8 = ((np.clip(result_u8.astype(np.float32), -1, 1)
                              + 1) / 2 * 255).astype(np.uint8)
        out = Image.fromarray(result_u8).resize((w_raw, h_raw))
        _save_png(out, os.path.join(self.static_root, "results", name))
        if save_to_input:
            _save_png(out, os.path.join(self.static_root, "images", name))
        return name

    # -- request handling ----------------------------------------------
    def handle_post(self, form: dict) -> str:
        idx = int(form.get("im_idx", ["0"])[0])
        if "changeim" in form:
            with self.lock:
                idx = (idx + 1) % max(1, len(self.examples))
            return f"/?idx={idx}"
        if "mask" in form:
            filename = form["imgname"][0]
            data = form["mask"][0]
            data = data.replace("data:image/png;base64,", "")
            data = data.replace(" ", "+")
            raw = base64.b64decode(data)
            maskname = ".".join(filename.split(".")[:-1]) + ".png"
            maskname = maskname.replace("/", "_")
            maskname = f"{random.randint(0, 1000)}_{maskname}"
            with open(os.path.join(self.static_root, "masks", maskname),
                      "wb") as fh:
                fh.write(raw)
            sketch = Image.open(io.BytesIO(raw)).convert("L")
            # the client-supplied name must stay inside static/images —
            # same containment guard as the GET /static/ handler (a
            # traversal like ../../etc/x would otherwise open and echo
            # back any PIL-readable file on the host)
            img_dir = os.path.realpath(
                os.path.join(self.static_root, "images"))
            img_path = os.path.realpath(os.path.join(img_dir, filename))
            if os.path.commonpath([img_path, img_dir]) != img_dir:
                raise ValueError(f"imgname escapes static/images: "
                                 f"{filename!r}")
            image = Image.open(img_path)
            result_name = "result_" + maskname
            self.process_image(image, sketch, result_name)
            # ThreadingHTTPServer runs handlers concurrently: the example
            # list and version counter are shared, so mutate them under
            # the lock (process_image serializes device access with the
            # same lock internally, so it must be taken after).
            with self.lock:
                self.examples.insert(0, result_name)
                # bound the example list (reference demo.py:24
                # declares max_num_examples=200); drop the oldest beyond it
                del self.examples[MAX_NUM_EXAMPLES:]
                self.version += 1
            return "/?idx=0"
        return f"/?idx={idx}"

    def render(self, idx: int = 0) -> str:
        with self.lock:     # snapshot against concurrent example inserts
            idx = idx % max(1, len(self.examples))
            name = self.examples[idx] if self.examples else ""
        path = os.path.join(self.static_root, "images", name)
        w = h = 256
        if os.path.isfile(path):     # empty list -> name "" is the dir
            with Image.open(path) as im:
                w, h = im.size
        return _PAGE.format(image_name=name, idx=idx, w=w, h=h,
                            version=self.version)


def make_handler(app: DemoApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, body: str, ctype="text/html"):
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path.startswith("/static/"):
                fpath = os.path.join(
                    app.static_root,
                    os.path.normpath(parsed.path[len("/static/"):]))
                if (os.path.isfile(fpath)
                        and os.path.commonpath(
                            [os.path.abspath(fpath),
                             os.path.abspath(app.static_root)])
                        == os.path.abspath(app.static_root)):
                    with open(fpath, "rb") as f:
                        data = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self.send_error(404)
                return
            qs = urllib.parse.parse_qs(parsed.query)
            idx = int(qs.get("idx", ["0"])[0])
            self._send(app.render(idx))

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length).decode()
                form = urllib.parse.parse_qs(body)
                try:
                    redirect = app.handle_post(form)
                except (KeyError, IndexError, ValueError, OSError) as e:
                    # malformed form / bad base64 / unopenable image —
                    # client error, answer 400 instead of dropping the
                    # connection (serve_api.py has the same contract)
                    self.send_error(
                        400, f"bad request: {type(e).__name__}")
                    return
                self._send(redirect, ctype="text/plain")
            except Exception:
                self.send_error(500)

    return Handler


def serve(app: DemoApp, port: int):
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(app))
    print(f"demo server listening on :{port}")
    server.serve_forever()
