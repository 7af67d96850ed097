"""Camera math for the demo (≙ `demo/lib/utils.py`), pure numpy — the
reference round-trips through torch for a 3-vector cross product. A copy of
`kasportsformer_tpu/demo/camera.py`."""

from __future__ import annotations

import numpy as np

# The fixed camera orientation quaternion used by the reference demo
# (`demo/demo.py:243`).
DEMO_CAMERA_QUATERNION = np.array(
    [0.1407056450843811, -0.1500701755285263, -0.755240797996521,
     0.6223280429840088], dtype=np.float32)


def normalize_screen_coordinates(x: np.ndarray, w: int, h: int) -> np.ndarray:
    """Map pixel xy to [-1, 1] keeping aspect (`demo/lib/utils.py:15-19`)."""
    assert x.shape[-1] in (2, 3)
    out = np.array(x, dtype=np.float32, copy=True)
    out[..., :2] = x[..., :2] / w * 2 - np.array([1, h / w], np.float32)
    return out


def qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v by quaternions q (`demo/lib/utils.py:55-68`)."""
    assert q.shape[-1] == 4 and v.shape[-1] == 3
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2 * (q[..., :1] * uv + uuv)


def camera_to_world(x: np.ndarray, rotation: np.ndarray,
                    translation: float | np.ndarray = 0) -> np.ndarray:
    """(`demo/lib/utils.py:71-73`)."""
    q = np.broadcast_to(rotation, (*x.shape[:-1], 4))
    return qrot(q, x) + translation
