"""Training: weighted loss, AdamW, LR schedule, train step and epoch loop
(port of `kasportsformer_tpu/train/loop.py`, ≙ `train_and_evaluate_sp.py:201-402`).

* The objective is the reference's, with a 0/1 weight per sample so the
  wraparound padding of a partial batch contributes nothing.
* AdamW(betas 0.9/0.999, eps 1e-8, decay on every parameter) is
  `torch.optim.AdamW`, whose update is optax's `adamw` step for step; the
  host schedule (linear warmup from lr/100 over `warmup_epoches`, then
  ReduceLROnPlateau(factor `learning_rate_decay`, patience 2)) sets the
  learning rate between epochs.
* `grad_microbatch = m` runs the batch as B/m forward+backward passes whose
  gradients are combined with their real-sample weight sums: the same
  weighted mean as the full batch, with the GCN batch norm taking
  per-microbatch statistics and updating its running statistics once per
  microbatch, as in the JAX scan.
* Shuffles come from `default_rng([seed, epoch])`; flips, and the
  stochastic-depth masks of a model whose forward takes a `generator` (the
  zoo's MixSTE and DSTFormer; the JAX step threads a key the same way),
  come from a generator seeded from (seed, epoch, step), so a
  kill-and-resume replays the uninterrupted run exactly.
* The attention kernels subtract the exact per-head max, so the JAX train
  step's NaN guard (`guarded_grads_fn`: an unchecked run, then a stable
  re-run on a NaN loss) has nothing to guard and is not ported.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from kasportsformer_torch.config import Config
from kasportsformer_torch.data.clips import ClipSet
from kasportsformer_torch.data.pipeline import (
    epoch_plan,
    flip_generator,
    random_flip_batch,
    take_batch,
    truncate_channels,
)
from kasportsformer_torch.skeleton import JOINT_LABELS
from kasportsformer_torch.train import checkpoint as ckpt
from kasportsformer_torch.train.evaluator import Evaluator
from kasportsformer_torch.train.losses import (
    cos_similarity_loss,
    cos_similarity_velocity_loss,
    limb_length_loss,
    limb_length_variance_loss,
    mpjpe_loss,
    n_mpjpe_loss,
    velocity_loss,
)
from kasportsformer_torch.utils.common import get_logger

# ------------------------------------------------------------ weighted loss


def _per_sample(fn: Callable, predict: torch.Tensor, target: torch.Tensor
                ) -> torch.Tensor:
    """A (1-sample-batch) loss applied to each sample -> (B,)."""
    return torch.func.vmap(lambda p, t: fn(p[None], t[None]))(predict, target)


def weighted_total_loss(predict: torch.Tensor, target: torch.Tensor,
                        weights: torch.Tensor, lambda_n_mpjpe: float,
                        lambda_mpjpe_velocity: float,
                        lambda_limb_len_var: float = 0.0,
                        lambda_limb_len: float = 0.0,
                        lambda_limb_cos_simi: float = 0.0,
                        lambda_limb_cos_simi_velocity: float = 0.0,
                        ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The reference objective (`train_and_evaluate_sp.py:212-222`) plus the
    limb family, as a weighted mean over samples (weights 0/1; all 1 gives
    `losses.total_loss`). Returns (total, components)."""
    w = weights / weights.sum().clamp(min=1.0)

    def wmean(fn: Callable) -> torch.Tensor:
        return (_per_sample(fn, predict, target) * w).sum()

    comps = {"loss_mpjpe": wmean(mpjpe_loss),
             "loss_n_mpjpe": wmean(n_mpjpe_loss),
             "loss_velocity": wmean(velocity_loss)}
    total = (comps["loss_mpjpe"] + lambda_n_mpjpe * comps["loss_n_mpjpe"]
             + lambda_mpjpe_velocity * comps["loss_velocity"])
    for lam, key, fn in (
            (lambda_limb_len_var, "loss_limb_len_var",
             lambda p, t: limb_length_variance_loss(p)),
            (lambda_limb_len, "loss_limb_len", limb_length_loss),
            (lambda_limb_cos_simi, "loss_limb_len_cos_simi", cos_similarity_loss),
            (lambda_limb_cos_simi_velocity, "loss_limb_len_cos_simi_velocity",
             cos_similarity_velocity_loss)):
        if lam:
            comps[key] = wmean(fn)
            total = total + lam * comps[key]
    comps["loss_total"] = total
    return total, comps


def _config_loss(config: Config, pred, y, w):
    return weighted_total_loss(
        pred, y, w, config.lambda_n_mpjpe, config.lambda_mpjpe_velocity,
        config.lambda_limb_len_var, config.lambda_limb_len,
        config.lambda_limb_cos_simi, config.lambda_limb_cos_simi_velocity)


# ------------------------------------------------------------ optimizer


def make_optimizer(model: nn.Module, config: Config) -> torch.optim.AdamW:
    """AdamW with torch's defaults (betas 0.9/0.999, eps 1e-8), decay on all
    parameters (the reference passes the full list,
    `train_and_evaluate_sp.py:270-272`)."""
    return torch.optim.AdamW(model.parameters(), lr=config.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=config.weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode 'min',
    relative threshold 1e-4, cooldown 0) as used at
    `train_and_evaluate_sp.py:273`; the JAX package's class, so the state
    dict matches."""

    def __init__(self, factor: float = 0.9, patience: int = 2,
                 threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = math.inf
        self.num_bad_epochs = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            lr = lr * self.factor
            self.num_bad_epochs = 0
        return lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, sd: dict) -> None:
        self.best = sd["best"]
        self.num_bad_epochs = sd["num_bad_epochs"]


def warmup_lr(config: Config, epoch: int) -> float | None:
    """Linear warmup from lr/100 over `warmup_epoches` epochs, applied while
    epoch <= warmup_epoches (`:325-329`); None after."""
    if config.warmup and epoch <= config.warmup_epoches:
        start = config.learning_rate / 100
        return start + (config.learning_rate - start) * (epoch / config.warmup_epoches)
    return None


# ------------------------------------------------------------ train step


def zero_unreached_grads(model: nn.Module) -> None:
    """Give every parameter the loss did not reach (`.grad` None: the limb
    norms of the attention and graph modules, as in the reference) a zero
    gradient, as JAX has, so AdamW decays it as optax does."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def make_grads_fn(model: nn.Module, config: Config):
    """`compute(x, y, weights) -> comps`: the gradient of the weighted-mean
    objective, added to the parameters' `.grad` (left None for a parameter
    the loss does not reach, so a cut graph shows), and the loss components
    (detached). The model runs in training mode (batch statistics, running
    statistics updated). With `config.grad_microbatch = m` dividing B (and
    m < B) the batch runs as B/m forward+backward passes, each scaled by its
    real-sample weight sum over the batch's: algebraically the full-batch
    gradient, with the live activations of an m-clip backward. A model whose
    forward takes a `generator` gets `generator`, from which it draws its
    stochastic-depth masks. A model whose train forward needs the target
    too (D3DP's diffusion objective: the target noised at a drawn timestep,
    then denoised) defines `train_predict(x, y, generator)`, which is called
    instead of its forward, as the JAX package's `loss_fn` calls it; a
    microbatch draws its own timesteps and noise."""
    takes_generator = "generator" in inspect.signature(model.forward).parameters
    has_train_predict = hasattr(model, "train_predict")

    def forward(x: torch.Tensor, y: torch.Tensor, generator: torch.Generator | None):
        if has_train_predict:
            return model.train_predict(x, y, generator)
        return model(x, generator=generator) if takes_generator else model(x)

    def compute(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        model.train()
        m, b = config.grad_microbatch, x.shape[0]
        if not m or m >= b or b % m:
            total, comps = _config_loss(config, forward(x, y, generator), y, weights)
            total.backward()
            out = {k: v.detach() for k, v in comps.items()}
        else:
            denom = weights.sum().clamp(min=1.0)
            acc: dict[str, torch.Tensor] = {}
            for xc, yc, wc in zip(x.split(m), y.split(m), weights.split(m)):
                total, comps = _config_loss(config, forward(xc, yc, generator),
                                            yc, wc)
                sw = wc.sum()
                (total * (sw / denom)).backward()
                for k, v in comps.items():
                    acc[k] = acc.get(k, 0.0) + v.detach() * sw
            out = {k: v / denom for k, v in acc.items()}
        return out

    return compute


def make_train_step(model: nn.Module, config: Config,
                    optimizer: torch.optim.Optimizer):
    """`step(arrays, idx, weights, generator) -> comps`: gather -> flip
    augmentation (mask from `generator`) -> forward (stochastic-depth masks
    from `generator` too, see `make_grads_fn`) -> loss -> backward -> AdamW,
    on the device of `arrays`."""
    grads_fn = make_grads_fn(model, config)

    def step(arrays: dict[str, torch.Tensor], idx, weights: torch.Tensor,
             generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        x = take_batch(arrays["inputs"], idx)
        y = take_batch(arrays["labels"], idx)
        if config.flip:
            x, y = random_flip_batch(x, y, generator)
        x = truncate_channels(x, config.input_channel_number)
        optimizer.zero_grad(set_to_none=True)
        comps = grads_fn(x, y, weights, generator)
        zero_unreached_grads(model)
        optimizer.step()
        return comps

    return step


# ------------------------------------------------------------ trainer


class Trainer:
    """Epoch loop: train -> evaluate -> schedule -> checkpoint ->
    early stop, with the reference's logging keys. The model trains in
    place on its own device."""

    def __init__(self, config: Config, model: nn.Module, train_set: ClipSet,
                 test_set: ClipSet, log=None, metric_sink=None):
        self.config = config
        self.model = model
        self.log = log or get_logger(config.logger_dir_path, config.logger_file_name)
        self.metric_sink = metric_sink  # callable(dict, step), wandb-shaped
        dev = next(model.parameters()).device
        self.device = dev
        self.train_arrays = {"inputs": torch.as_tensor(train_set.inputs, device=dev),
                             "labels": torch.as_tensor(train_set.labels, device=dev)}
        self.n_train = len(train_set)
        self.optimizer = make_optimizer(model, config)
        self.train_step = make_train_step(model, config, self.optimizer)
        self.evaluator = Evaluator(
            model, test_set, batch_size=config.eval_batch_size or config.batch_size,
            flip=config.flip, input_channel_number=config.input_channel_number)

    def fit(self, epochs: int | None = None, epoch_start: int = 0,
            min_mpjpe: float = math.inf, optimizer_state: dict | None = None,
            lr: float | None = None, scheduler_state: dict | None = None) -> dict:
        """Run the epoch loop. For a resume, pass what `resume_kwargs` makes
        of a checkpoint: the optimizer state, lr and scheduler state, or a
        warm run restarts at the full learning rate with fresh moments."""
        config = self.config
        if optimizer_state is not None:
            self.optimizer.load_state_dict(optimizer_state)
        scheduler = ReduceLROnPlateau(factor=config.learning_rate_decay, patience=2)
        if scheduler_state is not None:
            scheduler.load_state_dict(scheduler_state)
        lr = config.learning_rate if lr is None else lr
        patience_count = 0
        best_epoch = epoch_start
        epochs = config.epochs if epochs is None else epochs

        for epoch in range(epoch_start, epochs):
            self.log.info(f"train epoch: {epoch + 1} ...")
            wu = warmup_lr(config, epoch)
            if wu is not None:
                lr = wu
            set_learning_rate(self.optimizer, lr)
            plan = epoch_plan(self.n_train, config.batch_size,
                              np.random.default_rng([config.seed, epoch]))
            t0 = time.time()
            # loss components accumulate on the device; one sync an epoch
            totals: dict[str, torch.Tensor] = {}
            n_total = 0.0
            for s in range(plan.steps):
                weights = torch.as_tensor(plan.weights[s], device=self.device)
                comps = self.train_step(self.train_arrays, plan.indices[s], weights,
                                        flip_generator(config.seed, epoch, s))
                n_real = float(plan.weights[s].sum())
                n_total += n_real
                for k, v in comps.items():
                    totals[k] = totals.get(k, 0.0) + v * n_real
            loss_avgs = {k: float(v) / max(n_total, 1.0) for k, v in totals.items()}
            train_time = time.time() - t0

            result = self.evaluator.run()
            mpjpe = result["mpjpe"]
            self.log.info(
                f"epoch {epoch + 1}: MPJPE {mpjpe} mm  P-MPJPE {result['p_mpjpe']} mm  "
                f"accel {result['acceleration_error']}  "
                f"loss {loss_avgs.get('loss_total', float('nan')):.5f}  "
                f"({plan.steps} steps in {train_time:.1f}s)")

            improved = mpjpe < min_mpjpe
            if improved:
                min_mpjpe = mpjpe
                patience_count = 0
                best_epoch = epoch
            else:
                patience_count += 1

            # the scheduler steps only after warmup (`:393-397`) and BEFORE
            # the save, so the checkpoint carries the lr and plateau state
            # the next epoch needs
            lr_used = lr
            if not config.warmup or epoch > config.warmup_epoches:
                lr = scheduler.step(mpjpe, lr)

            interval = config.checkpoint_interval
            if interval > 0:
                if improved:
                    self._save(scheduler, epoch, lr, min_mpjpe, tag="best")
                if (epoch + 1) % interval == 0 or epoch == epochs - 1:
                    self._save(scheduler, epoch, lr, min_mpjpe, tag="latest")

            self._log_metrics(epoch, lr_used, loss_avgs, result, min_mpjpe)
            if patience_count >= config.training_epoch_patience:
                self.log.info(
                    f"No improvement for {patience_count} epochs, early stop. "
                    f"Min MPJPE {min_mpjpe} at epoch {best_epoch + 1}")
                break
        return {"min_mpjpe": min_mpjpe, "best_epoch": best_epoch}

    def _log_metrics(self, epoch, lr, loss_avgs, result, min_mpjpe) -> None:
        payload = {
            "learning_rate": lr,
            **{f"train/{k}": v for k, v in loss_avgs.items()},
            "eval/mpjpe": result["mpjpe"],
            "eval/p-mpjpe": result["p_mpjpe"],
            "eval/min_mpjpe": min_mpjpe,
            "eval/acceleration_error": result["acceleration_error"],
            "eval_additional/upper_body_mpjpe": result["upper_body_mpjpe"],
            "eval_additional/lower_body_mpjpe": result["lower_body_mpjpe"],
        }
        for j, label in enumerate(JOINT_LABELS):
            payload[f"eval_joint/{label}"] = float(result["mpjpe_joint"][j])
        for name, value in zip(result["activity_name_sequence"],
                               result["mpjpe_activity"]):
            payload[f"eval_activity/{name}"] = value
        if self.metric_sink is not None:
            self.metric_sink(payload, epoch + 1)

    def _save(self, scheduler, epoch, lr, min_mpjpe, tag: str) -> None:
        directory = os.path.join(self.config.new_checkpoint_dir,
                                 f"{self.config.new_checkpoint_name}_{tag}")
        ckpt.save_native(directory, 0, {"model": self.model.state_dict(),
                                        "optimizer": self.optimizer.state_dict()})
        # the JAX sidecar's schema: one for save and resume alike
        meta = {
            "epoch": epoch + 1,
            "learning_rate": float(lr),
            "min_mpjpe": float(min_mpjpe),
            "scheduler_best": (scheduler.best if math.isfinite(scheduler.best)
                               else None),
            "scheduler_bad_epochs": scheduler.num_bad_epochs,
            "wandb_run_id": self.config.wandb_run_id or "",
        }
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f)


def load_checkpoint_meta(directory: str) -> dict:
    with open(os.path.join(directory, "meta.json")) as f:
        return json.load(f)


def resume_kwargs(meta: dict, optimizer_state: dict) -> dict:
    """`Trainer.fit` keyword arguments of a resume, from a checkpoint's
    meta.json and its restored optimizer state."""
    best = meta.get("scheduler_best")
    return {
        "epoch_start": int(meta["epoch"]),
        "min_mpjpe": float(meta["min_mpjpe"]),
        "optimizer_state": optimizer_state,
        "lr": float(meta["learning_rate"]),
        "scheduler_state": {
            "best": math.inf if best is None else float(best),
            "num_bad_epochs": int(meta["scheduler_bad_epochs"]),
        },
    }
