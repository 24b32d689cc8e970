"""The port's serve CLI, end to end on the CPU: one live
``python -m sketchedit_tpu_torch.cli.serve --device cpu --edit_size 64
--max_batch 2 --compute_dtype float32`` process serving JAX-layout ``.npz``
checkpoints; the cases of tests/test_serve_api.py (JSON, raw single and
bulk, 400 / 404 / 413, /healthz, /stats polled), and the served edit held to
the JAX package's ``edit_u8`` on the same weights and input within 1 LSB.

Every wait has its own limit: 120 s for the server to warm up, 60 s per
request, 30 s for the process to exit.
"""

import base64
import http.client
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from sketchedit_tpu.models import editline2 as j_e
from sketchedit_tpu_torch.cli import serve
from sketchedit_tpu_torch.options import parse_argv
from sketchedit_tpu_torch.server import rawproto
from sketchedit_tpu_torch.utils.procutil import die_with_parent
from test_torch_edit import jax_params      # scaled kaiming weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
WARMUP_S, REQUEST_S, EXIT_S = 120, 60, 30
MODEL_FLAGS = ["--joint_train_inp", "--use_cam", "--pool_type", "max",
               "--dataset_mode", "base"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def params():
    return jax_params(4)


@pytest.fixture(scope="module")
def api_server(tmp_path_factory, params):
    ck = tmp_path_factory.mktemp("ck")
    os.makedirs(ck / "x")
    for net in ("M", "G"):
        np.savez(ck / "x" / f"latest_net_{net}.npz",
                 **{f"{layer}/{leaf}": v for layer, p in params[net].items()
                    for leaf, v in p.items()})
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.serve",
         "--name", "x", "--checkpoints_dir", str(ck), *MODEL_FLAGS,
         "--port", str(port), "--max_batch", "2", "--edit_size", str(SIZE),
         "--compute_dtype", "float32", "--precision", "highest",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "SERVE_WARMUP_WATCHDOG_S": str(WARMUP_S)},
        cwd=REPO, preexec_fn=die_with_parent)
    seen = []
    listening = threading.Event()

    def drain():            # a full pipe would block the server
        for line in proc.stdout:
            seen.append(line)
            if "serve_api listening" in line:
                listening.set()
    threading.Thread(target=drain, daemon=True).start()
    try:
        deadline = time.time() + WARMUP_S
        while not listening.wait(0.2):
            if proc.poll() is not None or time.time() > deadline:
                pytest.fail(f"server did not come up (rc={proc.poll()}): "
                            + "".join(seen[-20:]))
        assert any("warmup done" in ln for ln in seen)
        assert not any("WARNING" in ln for ln in seen), "".join(seen)
        yield port
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=EXIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=EXIT_S)


def _b64_png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _request(port, data, ctype, path="/edit"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=REQUEST_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, None


def _post_json(port, body, as_json=True):
    status, raw = _request(
        port, (json.dumps(body) if as_json else body).encode(),
        "application/json")
    return status, (json.loads(raw) if raw else None)


def _post_raw(port, body):
    return _request(port, body, "application/octet-stream")


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=REQUEST_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, None


def _pair(seed, h, w):
    rs = np.random.RandomState(seed)
    return ((rs.rand(h, w, 3) * 255).astype(np.uint8),
            ((rs.rand(h, w) > 0.9) * 255).astype(np.uint8))


def _decode_png(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_served_edit_matches_jax_edit_u8(api_server, params):
    """A canvas-native frame is served without any resize: the response is
    the pipeline's uint8 output, held to JAX ``edit_u8`` within 1 LSB, and
    the JSON path returns the same pixels (PNG is lossless)."""
    img, sk = _pair(4, SIZE, SIZE)
    status, body = _post_raw(api_server, rawproto.encode(img, sk))
    assert status == 200
    comp, mask = rawproto.decode(body)
    want_c, want_m = j_e.edit_u8(params, jnp.asarray(img[None]),
                                 jnp.asarray(sk[None, :, :, None]))
    for got, want in ((comp, want_c[0]), (mask, want_m[0])):
        diff = np.abs(got.astype(np.int16) - np.asarray(want).astype(np.int16))
        assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert np.abs(comp.astype(int) - img).mean() > 5        # a real edit
    status, out = _post_json(api_server, {"image": _b64_png(img),
                                          "sketch": _b64_png(sk)})
    assert status == 200
    np.testing.assert_array_equal(_decode_png(out["image"]), comp)
    np.testing.assert_array_equal(_decode_png(out["mask"]), mask[:, :, 0])


@pytest.mark.parametrize("h,w", [(64, 64), (90, 160), (33, 20)])
def test_json_edit_keeps_the_input_size(api_server, h, w):
    img, sk = _pair(h, h, w)
    status, out = _post_json(api_server, {"image": _b64_png(img),
                                          "sketch": _b64_png(sk)})
    assert status == 200
    assert _decode_png(out["image"]).shape == (h, w, 3)
    assert _decode_png(out["mask"]).shape == (h, w)


@pytest.mark.parametrize("body,as_json", [
    ("not json at all", False), ('"abc"', False), ("[1, 2]", False),
    ({"image": 5, "sketch": 6}, True), ({"sketch": "eA=="}, True),
    ({"image": "bm90cG5n", "sketch": "bm90cG5n"}, True),
], ids=["not_json", "json_string", "json_list", "non_string_fields",
        "missing_key", "not_an_image"])
def test_json_client_errors_are_400(api_server, body, as_json):
    assert _post_json(api_server, body, as_json=as_json)[0] == 400


@pytest.mark.parametrize("body", [
    b"", b"NOPE" + b"\x01\x00" + b"\x40\x00" * 2,
    b"SKED" + b"\x09\x00" + b"\x40\x00" * 2,
    b"SKED" + b"\x01\x00" + b"\x40\x00\x40\x00" + b"x" * 7,
], ids=["empty", "magic", "version", "short"])
def test_raw_client_errors_are_400(api_server, body):
    assert _post_raw(api_server, body)[0] == 400


def test_raw_letterboxes_other_sizes(api_server):
    img, sk = _pair(5, 90, 160)
    status, body = _post_raw(api_server, rawproto.encode(img, sk))
    assert status == 200
    comp, mask = rawproto.decode(body)
    assert comp.shape == (90, 160, 3) and mask.shape == (90, 160, 1)


def test_raw_bulk_request_roundtrip(api_server):
    """Three frames in one POST come back as three frames, each at its own
    size and equal to its single-frame response."""
    frames_in = [_pair(6, SIZE, SIZE), _pair(7, 90, 160), _pair(8, SIZE, SIZE)]
    status, body = _post_raw(api_server, b"".join(
        rawproto.encode(*f) for f in frames_in))
    assert status == 200
    frames = rawproto.decode_frames(body)
    assert [f[0].shape for f in frames] == [(SIZE, SIZE, 3), (90, 160, 3),
                                            (SIZE, SIZE, 3)]
    for sent, got in zip(frames_in, frames):
        status, single = _post_raw(api_server, rawproto.encode(*sent))
        assert status == 200
        np.testing.assert_array_equal(got[0], rawproto.decode(single)[0])


def test_concurrent_posts_are_coalesced(api_server):
    """Four clients at once against max_batch 2: all answered, and /stats
    (polled: the batch counters land after the futures resolve) shows a
    batch of two."""
    out = [None] * 4

    def client(i):
        out[i] = _post_raw(api_server, rawproto.encode(*_pair(20 + i, SIZE,
                                                              SIZE)))
    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * REQUEST_S)
    assert [o[0] for o in out] == [200] * 4
    for _ in range(50):
        ex = json.loads(_get(api_server, "/stats")[1])["executor"]
        if ex["batch_size_histogram"].get("2"):
            break
        time.sleep(0.1)
    assert ex["batch_size_histogram"].get("2"), ex


def test_wrong_paths_are_404(api_server):
    assert _request(api_server, b"{}", "application/json", "/nope")[0] == 404
    assert _get(api_server, "/nope")[0] == 404


def test_oversized_and_negative_lengths(api_server):
    """A Content-Length above MAX_BODY is refused with 413 before the body
    is read; a negative one with 400."""
    for length, want in ((64 * 1024 * 1024 + 1, 413), (-5, 400)):
        conn = http.client.HTTPConnection("127.0.0.1", api_server,
                                          timeout=REQUEST_S)
        try:
            conn.putrequest("POST", "/edit")
            conn.putheader("Content-Type", "application/octet-stream")
            conn.putheader("Content-Length", str(length))
            conn.endheaders()
            assert conn.getresponse().status == want
        finally:
            conn.close()


def test_healthz_and_stats(api_server):
    assert _get(api_server, "/healthz") == (200, b"ok")
    img, sk = _pair(2, SIZE, SIZE)
    assert _post_json(api_server, {"image": _b64_png(img),
                                   "sketch": _b64_png(sk)})[0] == 200
    assert _post_raw(api_server, rawproto.encode(img, sk))[0] == 200
    assert _post_json(api_server, "nope", as_json=False)[0] == 400
    for _ in range(50):     # the raw ledger lands after the response write
        stats = json.loads(_get(api_server, "/stats")[1])
        if (stats["raw_path_stages"]["totals"]["bodies"] >= 1
                and stats["executor"]["requests_served"] >= 2):
            break
        time.sleep(0.1)
    assert stats["edit_size"] == SIZE and stats["max_batch"] == 2
    assert stats["http"]["ok"] >= 2 and stats["http"]["client_error"] >= 1
    assert stats["http"]["server_error"] == 0
    ex = stats["executor"]
    assert ex["requests_served"] >= 2 and ex["batch_errors"] == 0
    assert (sum(ex["batch_size_histogram"].values())
            == ex["batches_dispatched"] >= 1)
    for key in ("dispatch_ms", "assemble_ms", "scatter_ms"):
        assert ex[key]["p50"] is not None
    rp = stats["raw_path_stages"]
    assert rp["totals"]["frames"] >= rp["totals"]["bodies"] >= 1
    assert rp["per_frame_ms"]["wait"] > 0
    assert set(rp["per_frame_ms"]) == {
        "read", "decode", "letterbox", "submit", "wait", "to_u8", "encode",
        "write"}
    assert rp["host_ms_per_frame_excl_wait"] >= 0.0


# -- the CLI's own contract, in process -------------------------------------

def test_serve_defaults_and_refusals(tmp_path, monkeypatch):
    """Serving defaults (bfloat16, TF32 allowed, the card); no card and no
    --device cpu raises, for the model and for --serve_artifact (before
    any artifact is read); a ragged --edit_size is refused before anything
    is built."""
    opt = parse_argv(serve.ApiOptions, ["--checkpoints_dir", str(tmp_path)])
    assert (opt.device, opt.compute_dtype, opt.precision) == (
        "cuda", "bfloat16", "default")
    assert (opt.max_batch, opt.edit_size, opt.max_wait_ms) == (
        serve.MAX_BATCH, 256, 5.0)
    base = ["serve", "--checkpoints_dir", str(tmp_path), *MODEL_FLAGS]
    monkeypatch.setenv("SERVE_WARMUP_WATCHDOG_S", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", base)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main()
    monkeypatch.setattr(sys, "argv", base + ["--serve_artifact", "a.pt2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main()
    monkeypatch.setattr(sys, "argv", base + ["--edit_size", "100"])
    with pytest.raises(SystemExit, match="multiple of 8"):
        serve.main()
