"""HTTP serving of the lifter (port of `kasportsformer_tpu/serving.py`).

A threaded HTTP server around the model: a request's keypoints are
normalised, cut into n_frames clips, lifted with flip-TTA in batches of at
most `batch_size` clips, root-zeroed and returned as JSON. Eager PyTorch
needs no fixed shape, so a batch is not padded to `batch_size`; eval mode has
no cross-clip coupling, so the poses are those of the padded JAX service.

Endpoints:
  GET  /healthz  -> {"status": "ok", "model": ..., "params": N}
  POST /lift     -> body {"keypoints": [T][17][2|3], "width": W, "height": H,
                          "world": bool?}
                 -> {"poses": [T][17][3]}
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
from torch import nn

from kasportsformer_torch.demo.camera import (
    DEMO_CAMERA_QUATERNION,
    camera_to_world,
    normalize_screen_coordinates,
)
from kasportsformer_torch.demo.lifting import turn_into_clips
from kasportsformer_torch.train.evaluator import tta_forward
from kasportsformer_torch.utils.common import resolve_device


class LiftService:
    """Wraps a model with the flip-TTA lifting protocol on one device."""

    def __init__(self, model: nn.Module, n_frames: int = 27,
                 batch_size: int = 128, flip: bool = True,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.n_frames = n_frames
        self.batch_size = batch_size
        self.flip = flip
        self._lock = threading.Lock()  # one forward on the device at a time
        # warm-up: builds and loads the kernels before the first request
        self._lift(np.zeros((1, n_frames, 17, 3), np.float32))

    @torch.inference_mode()
    def _lift(self, clips: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(clips).to(self.device)
        pred = tta_forward(self.model, x, self.flip, chunk_size=self.batch_size)
        pred[:, :, 0, :] = 0.0
        return pred.cpu().numpy()

    def lift_sequence(self, keypoints: np.ndarray, width: int, height: int,
                      world: bool = False) -> np.ndarray:
        """(T, 17, 2|3) pixel keypoints -> (T, 17, 3) poses: root-relative
        camera space, or (world=True) world space grounded at z=0 and
        max-normalised like the demo renderer (`demo/demo.py:243-248`). The
        sequence is cut into n_frames clips (a short tail is stretched, as in
        the demo) and lifted batch_size clips at a time."""
        keypoints = np.asarray(keypoints, np.float32)
        if keypoints.ndim != 3 or keypoints.shape[1] != 17:
            raise ValueError("keypoints must be (T, 17, 2|3)")
        if keypoints.shape[-1] == 2:
            conf = np.ones((*keypoints.shape[:2], 1), np.float32)
            keypoints = np.concatenate([keypoints, conf], axis=-1)

        clips, downsample = turn_into_clips(keypoints[None], self.n_frames)
        batch = np.concatenate(
            [normalize_screen_coordinates(c[0], width, height)[None]
             for c in clips]).astype(np.float32)
        with self._lock:
            out = np.concatenate(
                [self._lift(batch[s:s + self.batch_size])
                 for s in range(0, len(batch), self.batch_size)])
        frames = [out[i] for i in range(len(out) - 1)]
        frames.append(out[-1][downsample])
        poses = np.concatenate(frames, axis=0)[: len(keypoints)]
        if world:
            poses = camera_to_world(poses, DEMO_CAMERA_QUATERNION, 0)
            poses[..., 2] -= poses[..., 2].min(axis=-1, keepdims=True)
            maxes = poses.reshape(poses.shape[0], -1).max(axis=1)
            poses = poses / maxes[:, None, None]
        return poses


def make_handler(service: LiftService, model_name: str, n_params: int):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": model_name,
                                 "params": n_params})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/lift":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                poses = service.lift_sequence(
                    np.asarray(req["keypoints"], np.float32),
                    int(req["width"]), int(req["height"]),
                    world=bool(req.get("world", False)))
                self._send(200, {"poses": poses.tolist()})
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(model: nn.Module, host: str = "127.0.0.1", port: int = 8000,
          n_frames: int = 27, batch_size: int = 128, flip: bool = True,
          model_name: str = "KASportsFormer",
          device: str | torch.device = "cuda") -> ThreadingHTTPServer:
    """Build the service and its server (returned unstarted: call
    .serve_forever(), or run it in a thread as the tests do)."""
    service = LiftService(model, n_frames, batch_size, flip, device)
    return ThreadingHTTPServer((host, port),
                               make_handler(service, model_name,
                                            model.parameter_count()))
