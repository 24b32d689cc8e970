"""The port's demo server on the CPU: the ``DemoApp`` cases of
tests/test_server.py in process (a stand-in pipeline, and the port's
``EditPipeline`` held to JAX ``edit_u8`` within 1 LSB), and the cases of
tests/test_demo_e2e.py against a live
``python -m sketchedit_tpu_torch.cli.demo --device cpu`` process.

Every wait has its own limit: 120 s for the server to come up, 60 s per
request, 30 s for the process to exit.
"""

import base64
import io
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from sketchedit_tpu.models import editline2 as j_e
from sketchedit_tpu_torch.cli import demo
from sketchedit_tpu_torch.models.editline2 import EditLine2Config
from sketchedit_tpu_torch.options import parse_argv
from sketchedit_tpu_torch.runner import EditPipeline
from sketchedit_tpu_torch.server import demo_server
from sketchedit_tpu_torch.server.demo_server import DemoApp, make_handler
from sketchedit_tpu_torch.utils.procutil import die_with_parent
from test_torch_edit import jax_params, port_model   # scaled kaiming weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STARTUP_S, REQUEST_S, EXIT_S = 120, 60, 30


class FakePipeline:
    """Stands in for the model: a halved image and a box mask."""

    def __call__(self, image, sketch):
        composed = np.clip(image * 0.5, -1, 1)
        mask = np.zeros_like(sketch)
        mask[:, 4:-4, 4:-4] = 1.0
        return composed, mask


def _example(seed=0, h=64, w=48):
    return Image.fromarray(
        (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8))


def _sketch_data_url(size=(48, 64), stroke=((10, 30), 20)):
    sk = Image.new("RGBA", size, (0, 0, 0, 0))
    (x0, x1), y = stroke
    for x in range(x0, x1):
        sk.putpixel((x, y), (0, 0, 255, 255))
    buf = io.BytesIO()
    sk.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.fixture
def app(tmp_path):
    static = tmp_path / "static"
    (static / "images").mkdir(parents=True)
    _example().save(static / "images" / "example.png")
    return DemoApp(FakePipeline(), static_root=str(static))


def test_render_lists_example(app):
    html = app.render(0)
    assert "example.png" in html and "canvas" in html
    assert "TPU" not in html


@pytest.mark.parametrize("w,h", [(50, 70), (2000, 12), (400, 4)],
                         ids=["round_to_8", "panorama", "floor_16px"])
def test_process_image_keeps_the_raw_size(app, w, h):
    name = app.process_image(_example(1, h, w), Image.new("L", (w, h), 0),
                             "out.png")
    out = Image.open(os.path.join(app.static_root, "results", name))
    assert out.size == (w, h)
    # edits chain: the result is saved back into images/
    assert os.path.exists(os.path.join(app.static_root, "images", name))


def test_post_mask_roundtrip(app):
    redirect = app.handle_post({"imgname": ["example.png"], "im_idx": ["0"],
                                "mask": [_sketch_data_url()]})
    assert redirect.startswith("/?idx=")
    results = os.listdir(os.path.join(app.static_root, "results"))
    assert len(results) == 1 and results[0].startswith("result_")
    assert len(os.listdir(os.path.join(app.static_root, "masks"))) == 1


def test_concurrent_posts_keep_examples_consistent(app):
    form = {"imgname": ["example.png"], "im_idx": ["0"],
            "mask": [_sketch_data_url()]}
    errors = []

    def edit():
        try:
            for _ in range(8):
                app.handle_post(form)
        except Exception as e:       # noqa: BLE001 - recorded for assert
            errors.append(e)

    def browse():
        try:
            for i in range(64):
                app.render(i)
                app.handle_post({"changeim": ["1"], "im_idx": [str(i)]})
        except Exception as e:       # noqa: BLE001
            errors.append(e)

    threads = ([threading.Thread(target=edit) for _ in range(4)]
               + [threading.Thread(target=browse) for _ in range(4)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(app.examples) == 1 + 4 * 8       # example.png + every edit
    assert app.version == 4 * 8
    app.render(0)


def test_example_list_capped_at_200(app):
    app.examples = [f"e{i}.png" for i in range(demo_server.MAX_NUM_EXAMPLES)]
    _example(2).save(os.path.join(app.static_root, "images", "e0.png"))
    app.handle_post({"imgname": ["e0.png"], "im_idx": ["0"],
                     "mask": [_sketch_data_url()]})
    assert len(app.examples) == demo_server.MAX_NUM_EXAMPLES
    assert app.examples[0].startswith("result_")


def test_change_example_cycles_and_empty_list(app, tmp_path):
    assert app.handle_post({"changeim": ["1"], "im_idx": ["0"]}) == "/?idx=0"
    empty = DemoApp(FakePipeline(), static_root=str(tmp_path / "s"))
    assert empty.examples == []
    assert empty.handle_post({"changeim": ["1"], "im_idx": ["0"]}) == "/?idx=0"
    assert "canvas" in empty.render(0).lower()


def test_post_rejects_path_traversal(app, tmp_path):
    secret = tmp_path / "secret.png"
    Image.new("RGB", (16, 16), (1, 2, 3)).save(secret)
    with pytest.raises(ValueError, match="escapes"):
        app.handle_post({"imgname": [f"../../{secret.name}"],
                         "im_idx": ["0"],
                         "mask": [_sketch_data_url((16, 16), ((2, 6), 3))]})
    assert os.listdir(os.path.join(app.static_root, "results")) == []


def test_static_get_stays_inside_static_root(app, tmp_path):
    """The GET /static/ guard: a file inside is served, a traversal out of
    static_root is 404."""
    from http.server import ThreadingHTTPServer
    (tmp_path / "secret.txt").write_text("secret")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/static/images/example.png",
                timeout=REQUEST_S) as r:
            assert Image.open(io.BytesIO(r.read())).size == (48, 64)
        for path in ("/static/../secret.txt", "/static/%2e%2e/secret.txt",
                     "/static/images/missing.png"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                       timeout=REQUEST_S)
            assert err.value.code == 404, path
    finally:
        server.shutdown()
        server.server_close()


def test_demo_edit_matches_jax_edit_u8(tmp_path):
    """process_image on the port's pipeline: a 64^2 example needs no
    resize, so the saved result is the pipeline's uint8 output, held to JAX
    ``edit_u8`` on the same weights within 1 LSB."""
    params = jax_params(4)
    pipeline = EditPipeline(model=port_model(params),
                            config=EditLine2Config(),
                            device=torch.device("cpu"))
    app = DemoApp(pipeline, static_root=str(tmp_path / "static"))
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    sk = ((rs.rand(64, 64) > 0.9) * 255).astype(np.uint8)
    name = app.process_image(Image.fromarray(img), Image.fromarray(sk),
                             "r.png", save_to_input=False)
    got = np.asarray(Image.open(os.path.join(app.static_root, "results",
                                             name)))
    want, _ = j_e.edit_u8(params, jnp.asarray(img[None]),
                          jnp.asarray(sk[None, :, :, None]))
    diff = np.abs(got.astype(np.int16) - np.asarray(want[0]).astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert np.abs(got.astype(int) - img).mean() > 5


def test_face_crop_goes_through_the_composite(tmp_path):
    """--face_crop: the edit is confined to the crop around the strokes; far
    pixels pass through (up to the uint8 round trip)."""
    app = DemoApp(FakePipeline(), static_root=str(tmp_path / "static"),
                  face_crop=True)
    rs = np.random.RandomState(0)
    img = rs.randint(60, 256, (128, 128, 3)).astype(np.uint8)
    sk = np.zeros((128, 128), np.uint8)
    sk[30:50, 40:60] = 255
    name = app.process_image(Image.fromarray(img), Image.fromarray(sk),
                             "face.png")
    out = np.asarray(Image.open(os.path.join(app.static_root, "results",
                                             name))).astype(int)
    assert np.abs(out[120:, 120:] - img[120:, 120:]).max() <= 1
    assert np.abs(out[38:42, 48:52] - img[38:42, 48:52]).mean() > 20


def test_demo_defaults_and_no_gpu(tmp_path, monkeypatch):
    opt = parse_argv(demo.DemoOptions, ["--checkpoints_dir", str(tmp_path)])
    assert (opt.device, opt.compute_dtype, opt.precision, opt.face_crop) == (
        "cuda", "bfloat16", "default", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["demo", "--checkpoints_dir",
                                      str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main()


# -- a live demo process ------------------------------------------------------

@pytest.fixture(scope="module")
def demo_process(tmp_path_factory):
    work = tmp_path_factory.mktemp("demo")
    imgdir = work / "static" / "images"
    imgdir.mkdir(parents=True)
    _example(0, 64, 64).save(imgdir / "example.png")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.demo",
         "--name", "x", "--checkpoints_dir", str(work / "ck"),
         "--joint_train_inp", "--use_cam", "--pool_type", "max",
         "--dataset_mode", "base", "--port", str(port),
         "--compute_dtype", "float32", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO + os.pathsep
             + os.environ.get("PYTHONPATH", "")},
        cwd=str(work),                  # static/ lives under the tmp cwd
        preexec_fn=die_with_parent)
    seen = []
    listening = threading.Event()

    def drain():
        for line in proc.stdout:
            seen.append(line)
            if "demo server listening" in line:
                listening.set()
    threading.Thread(target=drain, daemon=True).start()
    try:
        deadline = time.time() + STARTUP_S
        while not listening.wait(0.2):
            if proc.poll() is not None or time.time() > deadline:
                pytest.fail(f"demo did not come up (rc={proc.poll()}): "
                            + "".join(seen[-20:]))
        yield port
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=EXIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=EXIT_S)


def test_canvas_page_and_edit_roundtrip(demo_process):
    base = f"http://127.0.0.1:{demo_process}"
    with urllib.request.urlopen(base + "/", timeout=REQUEST_S) as r:
        page = r.read().decode()
    assert "example.png" in page and "canvas" in page.lower()
    form = urllib.parse.urlencode({
        "imgname": "example.png", "im_idx": "0",
        "mask": _sketch_data_url((64, 64), ((10, 50), 20))}).encode()
    with urllib.request.urlopen(urllib.request.Request(base + "/", data=form),
                                timeout=REQUEST_S) as r:
        assert r.read().decode() == "/?idx=0"
    with urllib.request.urlopen(base + "/?idx=0", timeout=REQUEST_S) as r:
        page2 = r.read().decode()
    assert "result_" in page2
    name = page2.split('/static/images/')[1].split('"')[0].split("?")[0]
    with urllib.request.urlopen(f"{base}/static/images/{name}",
                                timeout=REQUEST_S) as r:
        assert Image.open(io.BytesIO(r.read())).size == (64, 64)


def test_malformed_post_is_400(demo_process):
    form = urllib.parse.urlencode({"mask": "@@@notbase64"}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{demo_process}/",
                                 data=form)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=REQUEST_S)
    assert err.value.code == 400
