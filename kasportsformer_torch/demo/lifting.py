"""Clip cutting of the 3D lifting stage (copy of the numpy helpers of
`kasportsformer_tpu/demo/lifting.py`, ≙ `demo/demo.py:132-156`). The rest of
the demo waits for the demo slice."""

from __future__ import annotations

import numpy as np


def resample_indices(n_frames: int, target: int) -> np.ndarray:
    """Deterministic floor resample (`demo/demo.py:132-136`)."""
    even = np.linspace(0, n_frames, num=target, endpoint=False)
    return np.clip(np.floor(even), 0, n_frames - 1).astype(np.int64)


def turn_into_clips(keypoints: np.ndarray, target_len: int = 27
                    ) -> tuple[list[np.ndarray], np.ndarray]:
    """Chunk a (P, T, 17, C) keypoint track into fixed-length clips; a short
    tail (or short video) is stretched by resampling, and `downsample` maps
    the stretched clip back to its unique source frames
    (`demo/demo.py:139-156`)."""
    clips = []
    n_frames = keypoints.shape[1]
    downsample = np.arange(target_len)
    if n_frames <= target_len:
        idx = resample_indices(n_frames, target_len)
        clips.append(keypoints[:, idx])
        downsample = np.unique(idx, return_index=True)[1]
    else:
        for start in range(0, n_frames, target_len):
            chunk = keypoints[:, start:start + target_len]
            if chunk.shape[1] != target_len:
                idx = resample_indices(chunk.shape[1], target_len)
                clips.append(chunk[:, idx])
                downsample = np.unique(idx, return_index=True)[1]
            else:
                clips.append(chunk)
    return clips, downsample
