"""Shared set-up of the tests that hold kasportsformer_torch against the JAX
package: one set of weights, drawn with numpy, loaded into both."""

from __future__ import annotations

import numpy as np


def perturb_tree(tree: dict, rng: np.random.Generator) -> dict:
    """Re-draw every leaf of a JAX (params, state) pytree at O(0.1-1) scale,
    as numpy float32. At init the layer scales are 1e-5 and the fusion gate
    is constant, which would leave most of the trunk untested."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = perturb_tree(leaf, rng)
            continue
        if isinstance(leaf, list):  # e.g. the MS-TCN's branches
            out[name] = [perturb_tree(t, rng) for t in leaf]
            continue
        shape = np.shape(leaf)
        if name == "var":  # batch-norm running variance
            new = rng.uniform(0.5, 1.5, shape)
        elif name in ("ls1", "ls2"):
            new = rng.uniform(0.1, 0.5, shape)
        elif name == "scale":  # LayerNorm / batch-norm weight
            new = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "w" and len(shape) >= 4:  # conv (.., O, I, kh, kw)
            new = rng.standard_normal(shape) / np.sqrt(np.prod(shape[-3:]))
        elif name == "w" and len(shape) >= 2:  # linear (.., in, out)
            new = rng.standard_normal(shape) / np.sqrt(shape[-2])
        else:  # biases, running means, position embeddings, limb MLPs
            new = 0.3 * rng.standard_normal(shape)
        out[name] = new.astype(np.float32)
    return out


def jax_flagship(seed: int, **cfg_kwargs):
    """A JAX KASportsFormer with perturbed weights: (model, params, state)
    with numpy leaves."""
    import jax

    from kasportsformer_tpu.models.kasportsformer import (
        KASportsFormer,
        KASportsFormerConfig,
    )

    model = KASportsFormer(KASportsFormerConfig(**cfg_kwargs))
    params, state = model.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = perturb_tree(jax.tree.map(np.asarray, params), rng)
    state = perturb_tree(jax.tree.map(np.asarray, state), rng)
    return model, params, state


def torch_flagship(params: dict, state: dict, **cfg_kwargs):
    """The port's KASportsFormer on the CPU, with the JAX weights loaded."""
    from kasportsformer_torch.models.kasportsformer import (
        KASportsFormer,
        KASportsFormerConfig,
    )
    from kasportsformer_torch.train.checkpoint import state_dict_from_jax

    model = KASportsFormer(KASportsFormerConfig(**cfg_kwargs))
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return model.eval()


def jax_forward(model, params, state, x: np.ndarray) -> np.ndarray:
    import jax

    fwd = jax.jit(lambda p, s, xx: model.apply(p, s, xx, train=False)[0])
    return np.asarray(fwd(params, state, x))


def torch_forward(model, x: np.ndarray) -> np.ndarray:
    import torch

    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


SMALL = dict(n_layers=3, dim_feat=32, num_heads=4, dim_rep=64)
