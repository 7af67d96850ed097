"""Training losses (port of `kasportsformer_tpu/train/losses.py`, ≙ the
reference's `utils/loss_calc.py`): same math, same reductions. All take
(B, T, 17, 3) tensors unless noted."""

from __future__ import annotations

import numpy as np
import torch

from kasportsformer_torch.skeleton import ANGLE_PAIRS, LIMB_PAIRS

_LIMB_A = [p[0] for p in LIMB_PAIRS]
_LIMB_B = [p[1] for p in LIMB_PAIRS]
_ANGLE_A = [p[0] for p in ANGLE_PAIRS]
_ANGLE_B = [p[1] for p in ANGLE_PAIRS]

# Per-joint weights of weighted MPJPE (`utils/loss_calc.py:108`).
WEIGHTED_MPJPE_W = np.array(
    [1, 1, 2.5, 2.5, 1, 2.5, 2.5, 1, 1, 1, 1.5, 1.5, 4, 4, 1.5, 4, 4],
    dtype=np.float32)


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm whose gradient at exactly 0 is 0 (torch.norm's subgradient
    convention) instead of NaN: resampled clips duplicate frames, which can
    make a velocity difference exactly zero. The guard keys on `sq <= 0`, so
    a NaN input falls through to the square root and propagates: a diverged
    model gives a NaN loss, not a zero one."""
    sq = (x * x).sum(dim)
    zero = sq <= 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))


def mpjpe_loss(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error (`utils/loss_calc.py:6-10`)."""
    return _safe_norm(predict - target).mean()


def n_mpjpe_loss(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MPJPE after rescaling predict by the per-frame least-squares scale
    (`utils/loss_calc.py:13-18`)."""
    norm_predict = (predict ** 2).sum(3, keepdim=True).mean(2, keepdim=True)
    norm_target = (target * predict).sum(3, keepdim=True).mean(2, keepdim=True)
    return mpjpe_loss(norm_target / norm_predict * predict, target)


def velocity_loss(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MPJPE of first temporal differences (`utils/loss_calc.py:21-27`);
    0 for T <= 1."""
    if predict.shape[1] <= 1:
        return predict.new_zeros(())
    vel_p = predict[:, 1:] - predict[:, :-1]
    vel_t = target[:, 1:] - target[:, :-1]
    return _safe_norm(vel_p - vel_t).mean()


def limb_lengths(x: torch.Tensor) -> torch.Tensor:
    """(B, T, 17, 3) -> (B, T, 16) bone lengths (`utils/loss_calc.py:30-42`)."""
    return _safe_norm(x[:, :, _LIMB_A] - x[:, :, _LIMB_B])


def limb_length_variance_loss(x: torch.Tensor) -> torch.Tensor:
    """Mean temporal variance (unbiased) of bone lengths
    (`utils/loss_calc.py:45-51`)."""
    if x.shape[1] <= 1:
        return x.new_zeros(())
    return torch.var(limb_lengths(x), dim=1, unbiased=True).mean()


def limb_length_loss(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between predicted and target bone lengths
    (`utils/loss_calc.py:54-58`)."""
    return (limb_lengths(predict) - limb_lengths(target)).abs().mean()


def limb_angles(x: torch.Tensor) -> torch.Tensor:
    """(B, T, 17, 3) -> (B, T, 18) inter-bone angles in radians
    (`utils/loss_calc.py:61-78`). Norms are clamped below at 1e-8 as in
    torch's cosine_similarity, through `_safe_norm` so the backward stays
    finite at a zero-length bone."""
    eps = 1e-7
    bones = x[:, :, _LIMB_A] - x[:, :, _LIMB_B]
    a = bones[:, :, _ANGLE_A]
    b = bones[:, :, _ANGLE_B]
    na = _safe_norm(a).clamp(min=1e-8)
    nb = _safe_norm(b).clamp(min=1e-8)
    cos = (a * b).sum(-1) / (na * nb)
    return torch.arccos(cos.clamp(-1 + eps, 1 - eps))


def cos_similarity_loss(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between inter-bone angles (`utils/loss_calc.py:80-83`)."""
    return (limb_angles(predict) - limb_angles(target)).abs().mean()


def cos_similarity_velocity_loss(predict: torch.Tensor,
                                 target: torch.Tensor) -> torch.Tensor:
    """L1 between temporal differences of inter-bone angles
    (`utils/loss_calc.py:86-94`)."""
    if predict.shape[1] <= 1:
        return predict.new_zeros(())
    ap, at = limb_angles(predict), limb_angles(target)
    return ((ap[:, 1:] - ap[:, :-1]) - (at[:, 1:] - at[:, :-1])).abs().mean()


def weighted_2d_loss(predict: torch.Tensor, target: torch.Tensor,
                     conf: torch.Tensor) -> torch.Tensor:
    """Confidence-weighted 2D reprojection error (`utils/loss_calc.py:96-101`)."""
    return _safe_norm((predict[..., :2] - target[..., :2]) * conf).mean()


def weighted_mpjpe(predict: torch.Tensor, target: torch.Tensor,
                   w: torch.Tensor | None = None) -> torch.Tensor:
    """Per-joint weighted MPJPE (`utils/loss_calc.py:103-112`)."""
    if w is None:
        w = torch.as_tensor(WEIGHTED_MPJPE_W, device=predict.device)
    return (w * _safe_norm(predict - target)).mean()


def total_loss(predict: torch.Tensor, target: torch.Tensor,
               lambda_n_mpjpe: float, lambda_mpjpe_velocity: float,
               lambda_limb_len_var: float = 0.0, lambda_limb_len: float = 0.0,
               lambda_limb_cos_simi: float = 0.0,
               lambda_limb_cos_simi_velocity: float = 0.0,
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The reference objective (`train_and_evaluate_sp.py:212-222`) plus the
    limb family (lambdas 0 in all shipped configs). Returns (total,
    components keyed like the reference's loss meters)."""
    comps = {"loss_mpjpe": mpjpe_loss(predict, target),
             "loss_n_mpjpe": n_mpjpe_loss(predict, target),
             "loss_velocity": velocity_loss(predict, target)}
    total = (comps["loss_mpjpe"] + lambda_n_mpjpe * comps["loss_n_mpjpe"]
             + lambda_mpjpe_velocity * comps["loss_velocity"])
    for lam, key, value in (
            (lambda_limb_len_var, "loss_limb_len_var",
             lambda: limb_length_variance_loss(predict)),
            (lambda_limb_len, "loss_limb_len",
             lambda: limb_length_loss(predict, target)),
            (lambda_limb_cos_simi, "loss_limb_len_cos_simi",
             lambda: cos_similarity_loss(predict, target)),
            (lambda_limb_cos_simi_velocity, "loss_limb_len_cos_simi_velocity",
             lambda: cos_similarity_velocity_loss(predict, target))):
        if lam:
            comps[key] = value()
            total = total + lam * comps[key]
    comps["loss_total"] = total
    return total, comps
