"""kasportsformer_torch's serving layer: the lifting protocol against the JAX
`LiftService` with the same weights, and the HTTP contract of
tests/test_serving.py (health, round trip, 400/404, world space,
concurrency), on the CPU."""

import http.client
import json
import os
import select
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from kasportsformer_tpu.serving import LiftService as JaxLiftService
from kasportsformer_torch.cli import build_parser
from kasportsformer_torch.serving import LiftService, serve
from torch_parity import SMALL, jax_flagship, torch_flagship

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(29)
# small shapes gain nothing from intra-op threads: leave the cores to the
# suite's other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    return jax_flagship(7, **SMALL)


@pytest.fixture(scope="module")
def port_model(weights):
    _, params, state = weights
    return torch_flagship(params, state, **SMALL)


@pytest.fixture(scope="module")
def server(port_model):
    srv = serve(port_model, host="127.0.0.1", port=0, batch_size=2,
                device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def _request(server, method, path, payload=None):
    """`server` is an HTTP server object or a port number."""
    port = server if isinstance(server, int) else server.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    body = json.dumps(payload) if payload is not None else None
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


@pytest.mark.parametrize("world", [False, True])
def test_lift_service_matches_jax(weights, port_model, world):
    """Same weights, same keypoints: 81 frames -> 3 clips in batches of 2,
    flip-TTA, root-zeroed; JAX pads the last batch, the port does not pad.

    Whole clips on purpose: a stretched tail repeats frames, which makes
    exact ties in the temporal GCN's top-k. The port and an eager JAX forward
    keep those ties exact; the jitted JAX forward does not always, and a tie
    that falls the other way moves that clip far beyond rounding."""
    model, params, state = weights
    kpts = RNG.uniform(0, 1000, (81, 17, 2)).astype(np.float32)
    want = JaxLiftService(model, params, state, batch_size=2).lift_sequence(
        kpts, 1280, 720, world=world)
    got = LiftService(port_model, batch_size=2, device="cpu").lift_sequence(
        kpts, 1280, 720, world=world)
    assert got.shape == (81, 17, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_healthz(server, port_model):
    status, data = _request(server, "GET", "/healthz")
    assert status == 200
    assert data == {"status": "ok", "model": "KASportsFormer",
                    "params": port_model.parameter_count()}


def test_lift_roundtrip(server):
    kpts = RNG.uniform(0, 1000, (40, 17, 2)).tolist()
    status, data = _request(server, "POST", "/lift",
                            {"keypoints": kpts, "width": 1280, "height": 720})
    assert status == 200
    poses = np.asarray(data["poses"])
    assert poses.shape == (40, 17, 3) and np.isfinite(poses).all()
    np.testing.assert_allclose(poses[:, 0, :], 0.0, atol=1e-6)  # root-zeroed


def test_bad_requests(server):
    status, data = _request(server, "POST", "/lift", {"width": 10})
    assert status == 400 and "error" in data
    status, _ = _request(server, "POST", "/lift",
                         {"keypoints": [[1, 2]], "width": 10, "height": 10})
    assert status == 400
    status, _ = _request(server, "GET", "/nope")
    assert status == 404
    status, _ = _request(server, "POST", "/nope", {})
    assert status == 404


def test_concurrent_requests(server):
    kpts = RNG.uniform(0, 1000, (10, 17, 2)).tolist()
    results = []

    def call():
        results.append(_request(server, "POST", "/lift",
                                {"keypoints": kpts, "width": 640,
                                 "height": 480}))

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 4 and all(status == 200 for status, _ in results)
    first = np.asarray(results[0][1]["poses"])
    for _, data in results[1:]:
        np.testing.assert_array_equal(np.asarray(data["poses"]), first)


def test_lift_world_space(server):
    kpts = RNG.uniform(0, 1000, (10, 17, 2)).tolist()
    status, data = _request(server, "POST", "/lift",
                            {"keypoints": kpts, "width": 640, "height": 480,
                             "world": True})
    assert status == 200
    poses = np.asarray(data["poses"])
    # grounded (min z == 0 per frame) and max-normalised (max coord == 1)
    np.testing.assert_allclose(poses[..., 2].min(axis=-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(poses.reshape(10, -1).max(1), 1.0, atol=1e-5)


def test_service_defaults_to_cuda(port_model):
    if torch.cuda.is_available():
        pytest.skip("decides only where CUDA is absent")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LiftService(port_model)


def test_cli_serve_end_to_end(port_model, tmp_path):
    """`python -m kasportsformer_torch serve` on the CPU with a reference-style
    `.pth` ({'model': ...}, 'module.' prefix) and a YAML config."""
    cfg = tmp_path / "small.yaml"
    cfg.write_text("n_layers: 3\ndim_feat: 32\nnum_heads: 4\ndim_rep: 64\n")
    ckpt = tmp_path / "small.pth"
    torch.save({"model": {f"module.{k}": v
                          for k, v in port_model.state_dict().items()}}, ckpt)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kasportsformer_torch", "serve",
         "--config-path", str(cfg), "--checkpoint", str(ckpt),
         "--device", "cpu", "--port", "0", "--batch-size", "2"],
        cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        while not line.startswith("serving"):
            ready, _, _ = select.select([proc.stderr], [], [], 120)
            assert ready, "server did not start"
            line = proc.stderr.readline()
            assert line, "server exited"
        port = int(line.split(":")[-1].split()[0])
        status, data = _request(port, "GET", "/healthz")
        assert status == 200
        assert data["params"] == port_model.parameter_count()
        kpts = RNG.uniform(0, 1000, (27, 17, 2)).astype(np.float32)
        status, data = _request(port, "POST", "/lift", {
            "keypoints": kpts.tolist(), "width": 1280, "height": 720})
        assert status == 200
        want = LiftService(port_model, batch_size=2, device="cpu").lift_sequence(
            kpts, 1280, 720)
        np.testing.assert_allclose(np.asarray(data["poses"]), want,
                                   atol=1e-6, rtol=1e-6)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_serve_arguments():
    args = build_parser().parse_args(
        ["serve", "--config-path", "c.yaml", "--checkpoint", "w.pth"])
    assert (args.device, args.port, args.batch_size) == ("cuda", 8000, 128)
    args = build_parser().parse_args(
        ["serve", "--config-path", "c.yaml", "--checkpoint", "w.pth",
         "--device", "cpu", "--port", "0"])
    assert (args.device, args.port) == ("cpu", 0)
