"""Evaluation metrics (port of `kasportsformer_tpu/train/metrics.py`, ≙ the
reference's `utils/error_calc.py`), batched over leading axes: a clip is
(T, 17, 3), a batch (N, T, 17, 3); each metric reduces the last axes as
its docstring says and keeps the leading ones."""

from __future__ import annotations

import torch


def mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-frame MPJPE (`utils/error_calc.py:5-7`): (..., 17, 3) -> (...)."""
    return torch.linalg.vector_norm(predicted - target, dim=-1).mean(-1)


def jpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-frame per-joint position error (`utils/error_calc.py:10-12`):
    (..., 17, 3) -> (..., 17)."""
    return torch.linalg.vector_norm(predicted - target, dim=-1)


def acceleration_error(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-frame acceleration error (`utils/error_calc.py:15-19`):
    (..., T, 17, 3) -> (..., T-2); second temporal difference, joint mean."""
    acc_t = target[..., :-2, :, :] - 2 * target[..., 1:-1, :, :] + target[..., 2:, :, :]
    acc_p = (predicted[..., :-2, :, :] - 2 * predicted[..., 1:-1, :, :]
             + predicted[..., 2:, :, :])
    return torch.linalg.vector_norm(acc_p - acc_t, dim=-1).mean(-1)


def p_mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-frame Procrustes-aligned MPJPE (`utils/error_calc.py:21-48`):
    (..., 17, 3) -> (...). Per frame, the scale, rotation and translation of
    `predicted` nearest `target` (orthogonal Procrustes through a batched
    SVD, with the reflection fix), then MPJPE of the aligned prediction."""
    mu_x = target.mean(-2, keepdim=True)
    mu_y = predicted.mean(-2, keepdim=True)
    x0 = target - mu_x
    y0 = predicted - mu_y
    norm_x = torch.sqrt((x0 ** 2).sum((-2, -1), keepdim=True))
    norm_y = torch.sqrt((y0 ** 2).sum((-2, -1), keepdim=True))
    x0 = x0 / norm_x
    y0 = y0 / norm_y

    h = torch.matmul(x0.transpose(-2, -1), y0)  # (..., 3, 3)
    u, s, vt = torch.linalg.svd(h)
    v = vt.transpose(-2, -1)
    r = torch.matmul(v, u.transpose(-2, -1))
    # a reflection (det R < 0): flip the smallest singular vector and value
    sign_det = torch.sign(torch.linalg.det(r))  # (...)
    v = torch.cat([v[..., :, :2], v[..., :, 2:] * sign_det[..., None, None]], -1)
    s = torch.cat([s[..., :2], s[..., 2:] * sign_det[..., None]], -1)
    r = torch.matmul(v, u.transpose(-2, -1))

    tr = s.sum(-1)[..., None, None]
    a = tr * norm_x / norm_y
    t = mu_x - a * torch.matmul(mu_y, r)
    aligned = a * torch.matmul(predicted, r) + t
    return torch.linalg.vector_norm(aligned - target, dim=-1).mean(-1)


def clip_metrics(predicted: torch.Tensor, target: torch.Tensor
                 ) -> dict[str, torch.Tensor]:
    """All four eval metrics of a clip, or of a batch of clips
    (`train_and_evaluate_sp.py:74-81`)."""
    return {"mpjpe": mpjpe(predicted, target),
            "jpe": jpe(predicted, target),
            "acc_err": acceleration_error(predicted, target),
            "p_mpjpe": p_mpjpe(predicted, target)}
