"""The eval protocol (port of `kasportsformer_tpu/train/evaluator.py`, ≙
`train_and_evaluate_sp.py:27-149`): flip-TTA forward, root-zeroing,
de-normalisation, 2.5D scaling, root-centring and MPJPE / JPE /
acceleration / P-MPJPE on the model's device, then the action-balanced
reduction on the host. Clips are evaluated in order (the reference shuffles
its eval loader; the action-balanced means do not depend on the order)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from kasportsformer_torch.data.clips import ClipSet
from kasportsformer_torch.data.pipeline import take_batch, truncate_channels
from kasportsformer_torch.skeleton import (
    JOINT_LABELS,
    LOWER_BODY_JOINTS,
    NUM_JOINTS,
    UPPER_BODY_JOINTS,
)
from kasportsformer_torch.train import metrics as M
from kasportsformer_torch.utils.common import chunked_batch_apply, joint_flip


def tta_forward(model: nn.Module, x: torch.Tensor, flip: bool,
                chunk_size: int = 128) -> torch.Tensor:
    """Mean of the normal and the mirrored prediction
    (≙ `train_and_evaluate_sp.py:46-51`). The mirrored clips ride the same
    forward as one doubled batch `[x, flip(x)]`, run in chunks of
    `chunk_size` clips; eval mode has no cross-clip coupling (batch norm uses
    running statistics), so chunking changes no value.

    A model with an eval forward of its own (D3DP: DDIM sampling and the
    proposals' mean, its flip-TTA inside the sampler as its config says)
    defines `eval_predict(x)`, which replaces the generic flip-TTA and
    chunking (≙ the JAX `tta_forward`; its NaN guard is not ported, see
    `train/loop.py`)."""
    with torch.inference_mode():
        if hasattr(model, "eval_predict"):
            return model.eval_predict(x)
        if not flip:
            return chunked_batch_apply(model, x, chunk_size)
        both = torch.cat([x, joint_flip(x)], dim=0)
        pred, pred_flip = chunked_batch_apply(model, both, chunk_size).chunk(2)
        return (pred + joint_flip(pred_flip)) / 2


def denormalize_device(pred: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """Inverse screen normalisation per clip (≙ `train_and_evaluate_sp.py:65-66`):
    pred (B, T, 17, 3), res (B, 2) stored as (W, H)."""
    res_w = res[:, 0].reshape(-1, 1, 1, 1)
    res_h = res[:, 1].reshape(-1, 1, 1, 1)
    xy = (pred[..., :2] + torch.cat([torch.ones_like(res_w), res_h / res_w], -1)
          ) * res_w / 2
    return torch.cat([xy, pred[..., 2:] * res_w / 2], dim=-1)


def eval_step(model: nn.Module, arrays: dict[str, torch.Tensor], idx,
              flip: bool, input_channel_number: int = 3) -> dict[str, np.ndarray]:
    """One eval batch: per-frame metric arrays of the clips `idx`."""
    x = truncate_channels(take_batch(arrays["inputs"], idx), input_channel_number)
    gt = take_batch(arrays["labels_scaled"], idx)
    factor = take_batch(arrays["factors"], idx)
    res = take_batch(arrays["res"], idx)
    with torch.inference_mode():
        pred = tta_forward(model, x, flip).clone()
        pred[:, :, 0, :] = 0.0  # root-zero BEFORE de-normalising (`:55`)
        pred = denormalize_device(pred, res) * factor[:, :, None, None]
        pred = pred - pred[:, :, 0:1, :]
        gt = gt - gt[:, :, 0:1, :]
        out = M.clip_metrics(pred, gt)
    return {k: v.float().cpu().numpy() for k, v in out.items()}


class Evaluator:
    """Batched evaluator over a test ClipSet, whose arrays it keeps on the
    model's device."""

    def __init__(self, model: nn.Module, clipset: ClipSet, batch_size: int = 128,
                 flip: bool = True, input_channel_number: int = 3):
        if clipset.labels_scaled is None:
            raise ValueError("test ClipSet lacks scaled labels")
        self.model = model
        self.actions = np.asarray(clipset.actions)
        self.n = len(clipset)
        self.batch_size = batch_size
        self.flip = flip
        self.input_channel_number = input_channel_number
        dev = next(model.parameters()).device
        self.arrays = {name: torch.as_tensor(getattr(clipset, name), device=dev)
                       for name in ("inputs", "labels_scaled", "factors", "res")}

    def run(self) -> dict[str, Any]:
        """Full evaluation in eval mode (the model's mode is restored after);
        the reference's result dict (`train_and_evaluate_sp.py:129-136`) plus
        upper/lower-body means."""
        was_training = self.model.training
        self.model.eval()
        try:
            chunks: dict[str, list] = {"mpjpe": [], "jpe": [], "acc_err": [],
                                       "p_mpjpe": []}
            for s in range(0, self.n, self.batch_size):
                idx = np.arange(s, min(self.n, s + self.batch_size))
                out = eval_step(self.model, self.arrays, idx, self.flip,
                                self.input_channel_number)
                for key in chunks:
                    chunks[key].append(out[key])
        finally:
            self.model.train(was_training)
        metrics = {key: np.concatenate(vals) for key, vals in chunks.items()}

        # action-balanced: mean per action, then over actions
        # (`train_and_evaluate_sp.py:105-127`), actions in order of appearance
        names = [str(a) for a in self.actions]
        action_names = list(dict.fromkeys(names))
        mpjpe_a, p_mpjpe_a, acc_a = [], [], []
        joint_a = np.zeros((NUM_JOINTS, len(action_names)))
        for ai, name in enumerate(action_names):
            mask = np.asarray([a == name for a in names])
            mpjpe_a.append(float(metrics["mpjpe"][mask].mean()))
            p_mpjpe_a.append(float(metrics["p_mpjpe"][mask].mean()))
            acc_a.append(float(metrics["acc_err"][mask].mean()))
            joint_a[:, ai] = metrics["jpe"][mask].mean(axis=(0, 1))
        per_joint = joint_a.mean(axis=1)
        return {
            "mpjpe": float(np.mean(mpjpe_a)),
            "p_mpjpe": float(np.mean(p_mpjpe_a)),
            "acceleration_error": float(np.mean(acc_a)),
            "activity_name_sequence": action_names,
            "mpjpe_activity": mpjpe_a,
            "mpjpe_joint": per_joint,
            "upper_body_mpjpe": float(np.mean(per_joint[list(UPPER_BODY_JOINTS)])),
            "lower_body_mpjpe": float(np.mean(per_joint[list(LOWER_BODY_JOINTS)])),
        }


def format_eval_report(result: dict[str, Any]) -> str:
    """Per-action / per-joint tables (≙ `train_and_evaluate_sp.py:138-147`,
    `:189-199`)."""
    lines = [
        f"Protocol #1 Error (MPJPE): {result['mpjpe']} mm",
        f"Protocol #2 Error (P-MPJPE): {result['p_mpjpe']} mm",
        f"Acceleration Error: {result['acceleration_error']} mm/frame^2",
        "-- per activity --",
    ]
    for name, value in zip(result["activity_name_sequence"], result["mpjpe_activity"]):
        lines.append(f"  {name}: {value}")
    lines.append(f"-- per joint (upper body mean {result['upper_body_mpjpe']:.3f}, "
                 f"lower body mean {result['lower_body_mpjpe']:.3f}) --")
    for j, err in enumerate(result["mpjpe_joint"]):
        lines.append(f"  {j:2d} {JOINT_LABELS[j]}: {err}")
    return "\n".join(lines)
