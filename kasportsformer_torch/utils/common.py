"""Small shared helpers: the device contract, the logger, seeding, the
horizontal pose flip and a chunked batch apply (port of
`kasportsformer_tpu/utils/common.py`)."""

from __future__ import annotations

import logging
import os
import time
from typing import Callable

import numpy as np
import torch

from kasportsformer_torch.skeleton import FLIP_PERM


def resolve_device(device: str | torch.device) -> torch.device:
    """The port's entry points run on the card unless the caller asks for the
    CPU: a CUDA device without CUDA is an error, never a silent fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available. kasportsformer_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch versions of "
            "its kernels on the CPU.")
    return dev


def joint_flip(joints: torch.Tensor) -> torch.Tensor:
    """Mirror a pose horizontally: negate x, swap left/right joints
    (`utils/utilities.py:128-135`). Works on any (..., 17, C) tensor and is
    an involution."""
    perm = torch.as_tensor(FLIP_PERM, device=joints.device)
    flipped = joints.index_select(-2, perm)
    sign = torch.ones(joints.shape[-1], dtype=joints.dtype, device=joints.device)
    sign[0] = -1
    return flipped * sign


def chunked_batch_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                        x: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """Run `fn` over axis-0 chunks of at most `chunk_size` and concatenate.
    Inference only: in training the GCN batch norm would take per-chunk
    statistics. chunk_size <= 0 runs one call."""
    if chunk_size <= 0 or x.shape[0] <= chunk_size:
        return fn(x)
    return torch.cat([fn(xb) for xb in x.split(chunk_size)], dim=0)


def get_logger(dir_path: str, file_name: str,
               name: str = "kasportsformer_torch") -> logging.Logger:
    """Stream + timestamped file logger (cf. `utils/utilities.py:67-88`); no
    file when `dir_path` is empty."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    formatter = logging.Formatter(
        fmt="[%(asctime)s|%(filename)s|%(levelname)s] %(message)s",
        datefmt="%a %b %d %H:%M:%S %Y")
    stream = logging.StreamHandler()
    stream.setFormatter(formatter)
    logger.addHandler(stream)
    if dir_path:
        os.makedirs(dir_path, exist_ok=True)
        time_str = time.strftime("%Y-%m-%d-%H.%M", time.localtime())
        fhandler = logging.FileHandler(
            os.path.join(dir_path, time_str + file_name), mode="w")
        fhandler.setLevel(logging.DEBUG)
        fhandler.setFormatter(formatter)
        logger.addHandler(fhandler)
    logger.propagate = False
    return logger


def seed_everything(seed: int) -> None:
    """Seed numpy's and torch's global generators (cf.
    `utils/utilities.py:15-22`). The training path draws nothing from the
    global state: its weights come from a generator seeded with the
    config's seed (`models.build_model`), its shuffles from
    `default_rng([seed, epoch])` and its flips from generators seeded per
    step (`data/pipeline.py`)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
