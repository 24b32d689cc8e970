"""Serving from an exported program on the port, on the CPU: the ``.pt2``
artifact of ``server/artifact.py`` against the live ``edit_u8`` and against
the JAX package's artifact of the same weights, its bare-file and
import-free loads, ``ArtifactPipeline``, the export script, the serve CLI's
``--serve_artifact`` over HTTP (the cases of
tests/test_export_artifact.py::test_serve_api_from_artifacts and more),
and ``torch.library.opcheck`` on every kernel op.

Weights: test_torch_edit.py's scaled kaiming init, exported with
``attention_impl='kernel'`` so that the attention op lies in the graph (on
the CPU it runs the plain version). Tolerances: the loaded artifact equals
the live edit bit for bit (the same ops on the same device); against the
JAX artifact, uint8 within 1 LSB (float32 on both sides, a rounding
boundary may fall between them). The seed was picked so that no soft-mask
pixel lies within 1e-4 of the 0.5 threshold, and the test asserts that
margin, as test_torch_edit.py does.
"""

import base64
import io
import json
import os
import shutil
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
from sketchedit_tpu.models.deepfill_c2 import DeepFillConfig as JDeepFillConfig
from sketchedit_tpu.server.artifact import (
    export_edit_artifact as j_export, load_edit_artifact as j_load)
from sketchedit_tpu_torch.cli import serve
from sketchedit_tpu_torch.models import editline2 as t_e
from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
from sketchedit_tpu_torch.ops import attention_cuda
from sketchedit_tpu_torch.params.convert import jax_params_to_state_dict
from sketchedit_tpu_torch.server.artifact import (
    ArtifactPipeline, export_edit_artifact, load_edit_artifact)
from sketchedit_tpu_torch.utils.procutil import die_with_parent
from test_torch_edit import jax_params, u8_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SEED, MARGIN = 32, 9, 1e-4
WARMUP_S, REQUEST_S, EXIT_S = 120, 60, 30
# subprocesses: few threads, as the runner puts test files side by side
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the test runner puts several test files side
    by side on the host's cores, and these nets are small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _model(params):
    model = t_e.EditLine2(t_e.EditLine2Config(
        netg=DeepFillConfig(attention_impl="kernel")))
    for net in ("M", "G"):
        getattr(model, f"net{net}").load_state_dict(
            jax_params_to_state_dict(params[net]), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def params():
    return jax_params(SEED)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, params):
    """{batch: path} of the B = 1 and B = 2 artifacts at 32^2, and the
    model they were exported from."""
    d = tmp_path_factory.mktemp("art")
    model = _model(params)
    paths = {}
    for b in (1, 2):
        paths[b] = str(d / f"edit_b{b}.pt2")
        meta = export_edit_artifact(model, paths[b], size=SIZE, batch=b)
        assert meta["bytes"] > 0 and os.path.exists(paths[b] + ".json")
    return paths, model


@pytest.fixture(scope="module")
def loaded(artifacts):
    """{batch: the loaded call} of ``artifacts``."""
    return {b: load_edit_artifact(p) for b, p in artifacts[0].items()}


@pytest.fixture(scope="module")
def script_artifacts(tmp_path_factory):
    """The export script's B = 1 and B = 2 artifacts at 16^2 (fresh
    weights), and the script's run."""
    d = tmp_path_factory.mktemp("script")
    out = str(d / "a.pt2")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "export_serving_artifact_torch.py"),
         "--name", "x", "--checkpoints_dir", str(d),
         "--dataset_mode", "base", "--use_cam", "--pool_type", "max",
         "--joint_train_inp", "--export_size", "16", "--export_batch", "1,2",
         "--export_out", out, "--device", "cpu", "--attention_impl",
         "kernel"],
        capture_output=True, text=True, cwd=REPO, timeout=300, env=ENV)
    return {b: str(d / f"a_b{b}.pt2") for b in (1, 2)}, r


def test_artifact_matches_the_live_edit_bit_for_bit(artifacts, loaded):
    paths, model = artifacts
    call = loaded[2]
    assert call.meta == {**json.load(open(paths[2] + ".json"))}
    assert call.meta["attention_impl"] == "kernel"
    assert call.meta["forward_kernel"] == "default"
    assert call.meta["platforms"] == ["cpu"]
    img, sk = u8_inputs(SEED, SIZE, SIZE, B=2)
    got_c, got_m = call(img, sk)
    with torch.no_grad():
        want_c, want_m = t_e.edit_u8(model, torch.from_numpy(img),
                                     torch.from_numpy(sk))
    assert got_c.dtype == torch.uint8 and got_c.shape == (2, SIZE, SIZE, 3)
    torch.testing.assert_close(got_c, want_c, rtol=0, atol=0)
    torch.testing.assert_close(got_m, want_m, rtol=0, atol=0)
    program = torch.export.load(paths[2])
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets.count("sketchedit.attention_fwd.default") == 1


def test_bare_artifact_serves(artifacts, loaded, tmp_path):
    """A host that copied only the .pt2 still serves: batch and size come
    from the program's input specs, the precision from the file, and the
    loader applies it."""
    paths, _ = artifacts
    bare = str(tmp_path / "bare.pt2")
    shutil.copy(paths[2], bare)
    torch.backends.cudnn.allow_tf32 = True
    call = load_edit_artifact(bare)
    assert not torch.backends.cudnn.allow_tf32      # precision applied
    assert not os.path.exists(bare + ".json")
    assert call.meta["batch"] == 2 and call.meta["size"] == SIZE
    assert call.meta["precision"] == "highest"
    assert call.meta["forward_kernel"] == "default"
    img, sk = u8_inputs(SEED, SIZE, SIZE, B=2)
    for a, b in zip(call(img, sk), loaded[2](img, sk)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_load_imports_no_model_module(artifacts):
    paths, _ = artifacts
    code = (
        "import json, sys, numpy as np\n"
        "from sketchedit_tpu_torch.server.artifact import load_edit_artifact\n"
        f"call = load_edit_artifact({paths[1]!r})\n"
        f"c, m = call(np.zeros((1, {SIZE}, {SIZE}, 3), np.uint8),"
        f" np.zeros((1, {SIZE}, {SIZE}, 1), np.uint8))\n"
        "print(json.dumps([list(c.shape), sorted(n for n in sys.modules if "
        "n.startswith(('sketchedit_tpu_torch.models', "
        "'sketchedit_tpu_torch.runner', 'sketchedit_tpu.', 'jax')))]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=120, env=ENV)
    assert r.returncode == 0, r.stderr[-2000:]
    shape, imported = json.loads(r.stdout.strip().splitlines()[-1])
    assert shape == [1, SIZE, SIZE, 3] and imported == []


def test_artifact_matches_the_jax_artifact(loaded, params, tmp_path):
    img, sk = u8_inputs(SEED, SIZE, SIZE, B=2)
    soft = np.asarray(j_e.generate(
        params, jnp.asarray(img.astype(np.float32) / 127.5 - 1.0),
        jnp.asarray((sk > 0).astype(np.float32)))["mask"])
    assert np.abs(soft - 0.5).min() > MARGIN
    assert 0.05 < (soft > 0.5).mean() < 0.95
    jpath = str(tmp_path / "edit.shlo")
    j_export(params, jpath, size=SIZE, batch=2, config=j_e.EditLine2Config(
        netg=JDeepFillConfig(attention_impl="xla")))
    want = j_load(jpath)(img, sk)
    got = loaded[2](img, sk)
    for g, w in zip(got, want):
        diff = np.abs(g.numpy().astype(np.int16)
                      - np.asarray(w).astype(np.int16))
        assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    # the edit is not vacuous: the hole gets content unlike the input
    assert np.abs(np.asarray(want[0]).astype(int) - img).mean() > 5


def test_pipeline_pads_and_refuses(artifacts, script_artifacts):
    paths, _ = artifacts
    pipe = ArtifactPipeline([paths[2]])
    assert (pipe.size, pipe.batches, pipe.max_batch) == (SIZE, [2], 2)
    img, sk = u8_inputs(SEED, SIZE, SIZE, B=2)
    c1, m1 = pipe(img[:1], sk[:1])              # padded to the B = 2 program
    assert isinstance(c1, np.ndarray) and c1.shape == (1, SIZE, SIZE, 3)
    c2, m2 = pipe(np.repeat(img[:1], 2, 0), np.repeat(sk[:1], 2, 0))
    np.testing.assert_array_equal(c1[0], c2[0])
    np.testing.assert_array_equal(m1[0], m2[0])
    with pytest.raises(ValueError, match="exceeds"):
        pipe(np.repeat(img, 2, 0), np.repeat(sk, 2, 0))
    with pytest.raises(ValueError, match="disagree on size"):
        ArtifactPipeline([paths[2], script_artifacts[0][1]])


def test_export_script_writes_one_artifact_per_bucket(script_artifacts):
    paths, r = script_artifacts
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for b, path in paths.items():
        meta = json.load(open(path + ".json"))
        assert (meta["batch"], meta["size"]) == (b, 16)
        assert meta["attention_impl"] == "kernel"
        assert meta["bytes"] == os.path.getsize(path)


@pytest.mark.parametrize("flags", [["--attention_impl", "sharded"],
                                   ["--gpu_ids", "0,1"],
                                   ["--data_parallel", "2"]])
def test_serve_refuses_artifacts_on_several_devices(monkeypatch, flags):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--name", "x", "--serve_artifact", "a.pt2", "--device",
        "cpu", *flags])
    with pytest.raises(SystemExit, match="one device"):
        serve.main()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, data, ctype="application/json", path="/edit"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=REQUEST_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, None


def test_serve_cli_from_artifacts(artifacts, loaded, tmp_path):
    """The serve CLI serves from the artifacts alone (no checkpoint, no
    model build): --edit_size clipped to the artifacts' with a NOTE, the
    JSON edit equal to the B = 1 artifact's, 400 on a malformed body, 404
    on another path, /stats."""
    paths, _ = artifacts
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.serve",
         "--name", "x", "--checkpoints_dir", str(tmp_path),
         "--port", str(port), "--serve_artifact", paths[1],
         "--serve_artifact", paths[2], "--edit_size", "64",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**ENV, "SERVE_WARMUP_WATCHDOG_S": str(WARMUP_S)},
        cwd=REPO, preexec_fn=die_with_parent)
    seen, listening = [], threading.Event()

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
        log = "".join(seen)
        assert f"NOTE: --edit_size 64 -> {SIZE}" in log
        assert "batch buckets [1, 2]" in log and "WARNING" not in log

        img, sk = u8_inputs(SEED + 1, SIZE, SIZE)

        def png(a):
            buf = io.BytesIO()
            Image.fromarray(a).save(buf, format="PNG")
            return base64.b64encode(buf.getvalue()).decode()

        status, body = _post(port, json.dumps(
            {"image": png(img[0]), "sketch": png(sk[0, :, :, 0])}).encode())
        assert status == 200
        out = json.loads(body)
        got = np.asarray(Image.open(io.BytesIO(base64.b64decode(
            out["image"]))).convert("RGB"))
        want_c, want_m = loaded[1](img, sk)
        np.testing.assert_array_equal(got, want_c[0].numpy())
        got_m = np.asarray(Image.open(io.BytesIO(base64.b64decode(
            out["mask"]))))
        np.testing.assert_array_equal(got_m, want_m[0, :, :, 0].numpy())
        assert _post(port, b"{not json")[0] == 400
        assert _post(port, b"{}", path="/nope")[0] == 404
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=REQUEST_S) as r:
            stats = json.loads(r.read())
        assert stats["edit_size"] == SIZE and stats["max_batch"] == 2
        assert stats["http"]["ok"] == 1
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=EXIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=EXIT_S)


def _op_cases():
    rs = np.random.RandomState(0)
    B, N, P, D = 2, 5, 6, 8

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    Q, K, V, dO, Vs = t(B, N, D), t(B, P, D), t(B, P, D), t(B, N, D), t(B, N, D)
    lse, delta = t(B, N), t(B, N)
    keep = torch.from_numpy((rs.rand(B, P) > 0.3).astype(np.float32))
    ks = torch.from_numpy(rs.rand(B, D).astype(np.float32) + 0.5)
    f32 = torch.float32
    return [
        ("fwd_lse", attention_cuda._fwd_op,
         (Q, K, V, keep, ks, 10.0, f32, True)),
        ("fwd_bf16", attention_cuda._fwd_op,
         (Q.bfloat16(), K.bfloat16(), V.bfloat16(), keep, None, 10.0,
          torch.bfloat16, False)),
        ("fwd_shared", attention_cuda._fwd_shared_op,
         (Vs, ks, torch.ones(B, N), 10.0, f32, True)),
        ("fwd_dsplit", attention_cuda._fwd_dsplit_op,
         (Q, K, V, keep, ks, 10.0, f32, False)),
        ("dq", attention_cuda._dq_op, (Q, K, V, keep, lse, delta, dO, 10.0,
                                       ks)),
        ("dkdv", attention_cuda._dkdv_op, (Q, K, V, keep, lse, delta, dO,
                                           10.0, None)),
        ("dv", attention_cuda._dv_op, (Q, K, keep, lse, dO, 10.0, ks)),
        ("dk", attention_cuda._dk_op, (Q, K, V, keep, lse, delta, dO, 10.0,
                                       ks)),
    ]


@pytest.mark.parametrize("case", range(8), ids=[c[0] for c in _op_cases()])
def test_opcheck_on_the_cpu(case):
    """Schema, fake implementation and the traced graph of every kernel op
    (torch.library.opcheck), on CPU inputs."""
    _, op, args = _op_cases()[case]
    assert set(torch.library.opcheck(op, args).values()) == {"SUCCESS"}


def test_every_kernel_is_a_custom_op():
    names = {op._name for op in attention_cuda.OPS}
    assert names == {f"attention_{k}" for k in (
        "fwd", "fwd_shared", "fwd_dsplit", "dq", "dkdv", "dv", "dk")}
    for op in attention_cuda.OPS:
        assert hasattr(torch.ops.sketchedit, op._name)
