"""The zoo's training path against the JAX package, on the CPU: the port's
`make_grads_fn` on MixSTE, DSTFormer and MotionAGFormer in its four variants
and at 64 channels over 8 heads (small widths, depth 2, drop_path 0 so that
every MLP tail takes the fused LayerNorm-MLP, whose backward is K4 on the
card, and every attention core K2's) against the JAX package's
`make_grads_fn`, with the same numpy-drawn weights carried into both and the
same seeded batch: the loss components and every parameter's gradient."""

import jax
import numpy as np
import pytest
import torch

from kasportsformer_tpu.config import Config as JConfig
from kasportsformer_tpu.models.zoo.dstformer import (
    DSTFormer as JaxDSTFormer,
    DSTFormerConfig as JaxDSTFormerConfig,
)
from kasportsformer_tpu.models.zoo.mixste import (
    MixSTE as JaxMixSTE,
    MixSTEConfig as JaxMixSTEConfig,
)
from kasportsformer_tpu.models.zoo.motionagformer import (
    MotionAGFormer as JaxMotionAGFormer,
    MotionAGFormerConfig as JaxMotionAGFormerConfig,
)
from kasportsformer_tpu.train import loop as JL
from kasportsformer_torch.config import Config
from kasportsformer_torch.models.zoo.dstformer import DSTFormer, DSTFormerConfig
from kasportsformer_torch.models.zoo.mixste import MixSTE, MixSTEConfig
from kasportsformer_torch.models.zoo.motionagformer import (
    MotionAGFormer,
    MotionAGFormerConfig,
)
from kasportsformer_torch.train.checkpoint import (
    dstformer_state_dict_from_jax,
    mixste_state_dict_from_jax,
    motionagformer_state_dict_from_jax,
)
from kasportsformer_torch.train.loop import make_grads_fn
from torch_parity import perturb_tree

# small shapes gain nothing from intra-op threads: leave the cores to the
# suite's other workers
torch.set_num_threads(1)
# loss components rel 1e-5; gradients rtol 1e-4, atol 1e-6 (as the
# flagship's in test_torch_train.py)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


def _mag(**kw):
    """MotionAGFormer at depth 2, dim_rep 64: width 32 in 4 heads of 8 unless
    `kw` says otherwise (MotionAGFormer-XS's 64 channels over 8 heads)."""
    cfg = dict(n_layers=2, dim_feat=32, dim_rep=64, num_heads=4) | kw
    return (JaxMotionAGFormer, JaxMotionAGFormerConfig(**cfg), MotionAGFormer,
            MotionAGFormerConfig(**cfg), motionagformer_state_dict_from_jax)


# name -> (JAX class, JAX config, port class, port config, carrier): width
# 32 (MixSTE in 2 heads of 16, DSTFormer and MotionAGFormer in 4 of 8;
# hierarchical's branches 16 wide), MotionAGFormer also 64 in 8 heads of 8,
# depth 2, no drop path
MODELS = {
    "mixste": (JaxMixSTE, JaxMixSTEConfig(embed_dim=32, depth=2, num_heads=2,
                                          drop_path_rate=0.0),
               MixSTE, MixSTEConfig(embed_dim=32, depth=2, num_heads=2,
                                    drop_path_rate=0.0),
               mixste_state_dict_from_jax),
    "dstformer": (JaxDSTFormer, JaxDSTFormerConfig(dim_feat=32, dim_rep=64, depth=2,
                                                   num_heads=4, mlp_ratio=2.0,
                                                   drop_path_rate=0.0),
                  DSTFormer, DSTFormerConfig(dim_feat=32, dim_rep=64, depth=2,
                                             num_heads=4, mlp_ratio=2.0,
                                             drop_path_rate=0.0),
                  dstformer_state_dict_from_jax),
    "mag_base": _mag(),
    "mag_tcn": _mag(use_tcn=True),
    "mag_hierarchical": _mag(hierarchical=True),
    "mag_graph_only": _mag(graph_only=True),
    "mag_64_8_heads": _mag(dim_feat=64, num_heads=8),
}
# parameters the loss does not reach: hierarchical MotionAGFormer allocates
# the adaptive fusion, as the reference's layout has it, and never runs it
_UNREACHED = {"mag_hierarchical": ".fusion."}


def _batch(b: int = 3):
    rng = np.random.default_rng(51)
    x = rng.uniform(-1, 1, (b, 27, 17, 3)).astype(np.float32)
    y = (0.3 * rng.standard_normal((b, 27, 17, 3))).astype(np.float32)
    return x, y - y[:, :, :1], np.array([1, 1, 0], np.float32)[:b]


@pytest.mark.parametrize("name", list(MODELS))
def test_zoo_grads_match_jax_make_grads_fn(name):
    """One batch of 3 clips, the last padded (weight 0): the JAX package's
    `make_grads_fn` (full batch, no flips) and the port's on the same
    weights. The loss components within 1e-5 relative and every parameter's
    gradient within GRAD_TOL of JAX's, carried into the torch layout by the
    port's own weight carrier; no parameter is left without a gradient but
    those the loss does not reach (`_UNREACHED`), whose JAX gradient is
    zero."""
    jcls, jcfg, tcls, tcfg, carrier = MODELS[name]
    jmodel = jcls(jcfg)
    params, state = jax.eval_shape(jmodel.init, jax.random.key(7))
    rng = np.random.default_rng(7)
    params, state = perturb_tree(params, rng), perturb_tree(state, rng)
    port = tcls(tcfg)
    port.load_state_dict(carrier(params, state), strict=True)
    x, y, w = _batch()

    cfg = JConfig(batch_size=3, flip=False, grad_microbatch=0)
    grads, want_c, _ = jax.jit(JL.make_grads_fn(jmodel, cfg))(
        params, state, x, y, w, jax.random.key(0))
    want_g = carrier(jax.tree.map(np.asarray, grads), state)
    got_c = make_grads_fn(port, Config(batch_size=3, flip=False, grad_microbatch=0))(
        *(torch.from_numpy(a) for a in (x, y, w)))

    assert set(got_c) == set(want_c)
    for k, v in want_c.items():
        assert got_c[k].item() == pytest.approx(float(v), rel=1e-5), k
    named = dict(port.named_parameters())
    # the carrier writes a whole state_dict: the parameters' gradients and
    # the state as it was (MotionAGFormer's batch-norm statistics)
    assert set(want_g) == set(port.state_dict()) >= set(named)
    for n, p in named.items():
        if p.grad is None and _UNREACHED.get(name, "\0") in n:
            assert not want_g[n].numpy().any(), n  # JAX's gradient is zero too
            continue
        assert p.grad is not None, n
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(), **GRAD_TOL,
                                   err_msg=n)
