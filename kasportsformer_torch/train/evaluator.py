"""Flip test-time augmentation, the forward of the eval protocol and of the
serving path (port of `kasportsformer_tpu/train/evaluator.py:tta_forward`).
The rest of the eval protocol waits for the eval slice."""

from __future__ import annotations

import torch
from torch import nn

from kasportsformer_torch.utils.common import chunked_batch_apply, joint_flip


def tta_forward(model: nn.Module, x: torch.Tensor, flip: bool,
                chunk_size: int = 128) -> torch.Tensor:
    """Mean of the normal and the mirrored prediction
    (≙ `train_and_evaluate_sp.py:46-51`). The mirrored clips ride the same
    forward as one doubled batch `[x, flip(x)]`, run in chunks of
    `chunk_size` clips; eval mode has no cross-clip coupling (batch norm uses
    running statistics), so chunking changes no value."""
    with torch.inference_mode():
        if not flip:
            return chunked_batch_apply(model, x, chunk_size)
        both = torch.cat([x, joint_flip(x)], dim=0)
        pred, pred_flip = chunked_batch_apply(model, both, chunk_size).chunk(2)
        return (pred + joint_flip(pred_flip)) / 2
