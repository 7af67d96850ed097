"""Batch schedule and augmentation (port of `kasportsformer_tpu/data/pipeline.py`).

* `epoch_plan`: an index matrix (steps, B) for one epoch, shuffled for
  training and sequential for eval, padded by wraparound with a 0/1 weight
  mask, so partial batches keep their weighted-mean semantics. It is the JAX
  package's function verbatim (numpy), so with `default_rng([seed, epoch])`
  the port trains on the JAX trainer's batches in the JAX trainer's order.
* `random_flip_batch`: the per-sample 50 % horizontal flip of input and
  label together (`sp_dataset.py:75-78`). Its mask comes from a CPU
  `torch.Generator` seeded from (seed, epoch, step) (`flip_generator`), so a
  resumed run replays the flips of an uninterrupted one. It cannot match
  `jax.random.bernoulli` bit for bit; tests pass the mask in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kasportsformer_torch.utils.common import joint_flip


@dataclasses.dataclass
class EpochPlan:
    """Batch schedule for one pass over n samples."""

    indices: np.ndarray  # (steps, batch) int32
    weights: np.ndarray  # (steps, batch) float32; 0 marks wraparound padding
    steps: int
    batch_size: int


def epoch_plan(n: int, batch_size: int, rng: np.random.Generator | None = None
               ) -> EpochPlan:
    """Shuffled (rng given) or sequential epoch plan with wraparound padding."""
    order = rng.permutation(n) if rng is not None else np.arange(n)
    steps = -(-n // batch_size)
    padded = steps * batch_size
    idx = np.resize(order, padded).astype(np.int32)
    weights = np.zeros(padded, np.float32)
    weights[:n] = 1.0
    return EpochPlan(indices=idx.reshape(steps, batch_size),
                     weights=weights.reshape(steps, batch_size),
                     steps=steps, batch_size=batch_size)


def take_batch(array: torch.Tensor, idx) -> torch.Tensor:
    """Rows `idx` (a plan's int32 indices, numpy or tensor) of `array`, on
    `array`'s device."""
    idx = torch.as_tensor(np.asarray(idx, np.int64) if isinstance(idx, np.ndarray)
                          else idx, device=array.device)
    return array.index_select(0, idx)


def flip_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The CPU generator of one train step's flip mask, a function of
    (seed, epoch, step) alone."""
    state = np.random.SeedSequence([seed, epoch, step]).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def random_flip_batch(x: torch.Tensor, y: torch.Tensor,
                      generator: torch.Generator | None = None,
                      mask: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flip each sample of (B, T, 17, C) input and label together with
    probability 1/2. The (B,) bool mask is drawn on the CPU from `generator`
    unless given."""
    if mask is None:
        mask = torch.rand(x.shape[0], generator=generator) < 0.5
    m = torch.as_tensor(mask, device=x.device).reshape(-1, 1, 1, 1)
    return torch.where(m, joint_flip(x), x), torch.where(m, joint_flip(y), y)


def truncate_channels(x: torch.Tensor, input_channel_number: int) -> torch.Tensor:
    """2-channel mode: drop the confidence channel (`sp_dataset.py:85-86`)."""
    if input_channel_number == 2:
        return x[..., :2]
    return x
