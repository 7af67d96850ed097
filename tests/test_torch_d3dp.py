"""kasportsformer_torch's D3DP against the JAX package, on the CPU in float32
with the same numpy-drawn weights loaded into both: the schedule, the time
embedding, the denoiser, q_sample, the DDIM sampler with proposals and the
fused flip-TTA (the JAX draws injected), the eval protocol's forward, the
training objective through `make_grads_fn` (the JAX draws injected), the
weight carrier and serving.

`jnp.exp` and `torch.exp` differ by an ulp on some of the time embedding's
frequencies, which t = 999 turns into up to ~5e-5 in the embedding: the
denoiser and the sampler are held at 1e-5 with the JAX table loaded into the
port's `freqs` buffer, and the time embedding on the port's own table to a
bound derived from the tables' difference (`test_time_embedding_at_t999`)."""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kasportsformer_tpu.config import Config as JConfig
from kasportsformer_tpu.models.zoo import d3dp as jd3dp
from kasportsformer_tpu.train import loop as JL
from kasportsformer_tpu.train.checkpoint import d3dp_state_dict_to_params
from kasportsformer_torch.config import Config
from kasportsformer_torch.models import build_model
from kasportsformer_torch.models.zoo.d3dp import D3DP, D3DPConfig, cosine_beta_schedule
from kasportsformer_torch.serving import LiftService
from kasportsformer_torch.train.checkpoint import d3dp_state_dict_from_jax
from kasportsformer_torch.train.evaluator import tta_forward
from kasportsformer_torch.train.loop import make_grads_fn
from kasportsformer_torch.utils.common import joint_flip
from torch_parity import perturb_tree

RNG = np.random.default_rng(43)
torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
# the training objective's gradients, as the zoo's in test_torch_zoo_train.py
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
SMALL = dict(embed_dim=32, depth=2, num_heads=4)
X = RNG.standard_normal((2, 27, 17, 3)).astype(np.float32)


def jax_freqs(dim: int) -> np.ndarray:
    """The JAX package's frequency table, its expression in `_time_embedding`
    (`kasportsformer_tpu/models/zoo/d3dp.py:79`)."""
    half = dim // 2
    return np.asarray(jnp.exp(jnp.arange(half) * (-math.log(10000.0) / (half - 1))))


def _pair(**cfg):
    """(JAX model, params, port) with the JAX frequency table loaded."""
    cfg = {**SMALL, **cfg}
    jmodel = jd3dp.D3DP(jd3dp.D3DPConfig(**cfg))
    params, state = jax.eval_shape(jmodel.init, jax.random.key(7))
    params = perturb_tree(params, np.random.default_rng(7))
    port = D3DP(D3DPConfig(**cfg))
    port.load_state_dict(d3dp_state_dict_from_jax(params, {}), strict=True)
    with torch.no_grad():
        port.pose_estimator.time_mlp[0].freqs.copy_(
            torch.from_numpy(jax_freqs(cfg["embed_dim"]).copy()))
    return jmodel, params, port.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_schedule_matches_jax():
    np.testing.assert_array_equal(cosine_beta_schedule(1000),
                                  jd3dp.cosine_beta_schedule(1000))
    jmodel, port = jd3dp.D3DP(), D3DP(D3DPConfig(**SMALL))
    for name in ("alphas_cumprod", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(port, name), getattr(jmodel, name))


def test_time_embedding_at_t999():
    """At the published width (512) on the port's own frequencies: each
    differs from JAX's by at most an ulp, and the embedding at t = 999 from
    JAX's by at most the bound that difference gives. Where a frequency f
    differs, the argument t*f moves by t|df| plus the rounding of the
    product (an ulp of t*f); sin and cos pass that on and add at most an ulp
    of their value each side; fc1 spreads an input's error by |W1|, the
    exact GELU (slope within [-0.17, 1.13]) by 1.13, fc2 by |W2|; 1e-5, the
    model tolerance, covers the linears' summation order."""
    dim, t = 512, 999
    jmodel = jd3dp.D3DP(jd3dp.D3DPConfig(embed_dim=dim, depth=1))
    params = perturb_tree(jax.eval_shape(jmodel.init, jax.random.key(3))[0],
                          np.random.default_rng(3))
    port = D3DP(D3DPConfig(embed_dim=dim, depth=1))
    port.load_state_dict(d3dp_state_dict_from_jax(params, {}), strict=True)
    mlp = port.pose_estimator.time_mlp
    want = np.asarray(jd3dp._time_embedding(params["time_mlp"],
                                            jnp.asarray([t]), dim))[0]
    with torch.inference_mode():
        got = mlp[3](torch.nn.functional.gelu(mlp[1](mlp[0](torch.tensor([t])))))
    f_jax, f_port = jax_freqs(dim), mlp[0].freqs.numpy()
    df = np.abs(f_port.astype(np.float64) - f_jax)
    assert (df <= np.spacing(f_jax)).all()
    args = np.float32(t) * f_jax
    d_arg = np.where(df > 0, t * df + np.spacing(args), 0.0)
    emb = np.concatenate([np.sin(args), np.cos(args)])
    d_emb = np.concatenate([d_arg, d_arg]) + 2 * np.spacing(np.abs(emb))
    w1 = np.abs(np.asarray(params["time_mlp"]["fc1"]["w"], np.float64))
    w2 = np.abs(np.asarray(params["time_mlp"]["fc2"]["w"], np.float64))
    bound = (1.13 * (d_emb @ w1)) @ w2 + 1e-5
    err = np.abs(got[0].numpy() - want)
    assert (err <= bound).all(), (err.max(), bound.min())


def test_denoiser_matches_jax(pair):
    jmodel, params, port = pair
    x2d = RNG.standard_normal((3, 27, 17, 2)).astype(np.float32)
    x3d = RNG.standard_normal((3, 27, 17, 3)).astype(np.float32)
    t = np.array([999, 0, 417], np.int32)
    want = jax.jit(jmodel.denoise)(params, jnp.asarray(x2d), jnp.asarray(x3d),
                                   jnp.asarray(t))
    with torch.inference_mode():
        got = port.pose_estimator.denoise(_t(x2d), _t(x3d), _t(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_q_sample_matches_jax(pair):
    jmodel, _, port = pair
    x0 = RNG.standard_normal((4, 27, 17, 3)).astype(np.float32)
    noise = RNG.standard_normal((4, 27, 17, 3)).astype(np.float32)
    t = np.array([0, 1, 500, 999], np.int32)
    want = jmodel.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = port.q_sample(_t(x0), _t(t).long(), _t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def jax_draws(key: jax.Array, shape: tuple, steps: int) -> list:
    """The JAX sampler's draws: `k0, key = split(key)` for the initial pose,
    then `kn, key = split(key)` at each step but the last."""
    k0, key = jax.random.split(key)
    out = [jax.random.normal(k0, shape, jnp.float32)]
    for _ in range(steps - 1):
        kn, key = jax.random.split(key)
        out.append(jax.random.normal(kn, shape, jnp.float32))
    return [_t(a) for a in out]


@pytest.mark.parametrize("flip", [True, False])
def test_sampler_matches_jax(flip):
    """Two DDIM steps over two proposals, JAX's draws injected: every step's
    x_start, (B, steps, H, F, N, 3)."""
    jmodel, params, port = _pair(sampling_timesteps=2, num_proposals=2,
                                 flip_tta=flip)
    key = jax.random.key(11)
    want = np.asarray(jax.jit(jmodel.sample)(params, jnp.asarray(X), key))
    with torch.inference_mode():
        got = port.sample(_t(X), noise=jax_draws(key, (2, 2, 27, 17, 3), 2))
    assert got.shape == want.shape == (2, 2, 2, 27, 17, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sampler_draws_from_its_generator(pair):
    """Without injected draws the sampler takes them from a generator (seed 0
    by default), so a seed gives the same samples and another seed others."""
    port = pair[2]
    with torch.inference_mode():
        a = port.sample(_t(X))
        b = port.sample(_t(X), torch.Generator().manual_seed(0))
        c = port.sample(_t(X), torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_chunked_denoiser_changes_no_value():
    """JAX's sampler with its 2*B*H = 16-clip denoiser batch in chunks of 4
    (`denoise_chunk`: a `lax.map` of four calls) gives the samples of the
    port's one call on the whole batch, JAX's draws injected."""
    _, params, port = _pair(num_proposals=4)
    chunked = jd3dp.D3DP(jd3dp.D3DPConfig(**SMALL, num_proposals=4, denoise_chunk=4))
    key = jax.random.key(13)
    want = np.asarray(jax.jit(chunked.sample)(params, jnp.asarray(X), key))
    with torch.inference_mode():
        got = port.sample(_t(X), noise=jax_draws(key, (2, 4, 27, 17, 3), 1))
    assert got.shape == want.shape == (2, 1, 4, 27, 17, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fused_flip_equals_two_calls(pair):
    """One denoiser call on the stacked normal and mirrored batch gives what
    two calls give."""
    port = pair[2]
    x = _t(X)
    with torch.inference_mode():
        got = port.sample(x)[:, 0, 0]  # one step, one proposal
        x_t = torch.randn((2, 1, 27, 17, 3),
                          generator=torch.Generator().manual_seed(0))
        x_t = x_t.clamp(-1.1, 1.1).reshape(2, 27, 17, 3)
        t = torch.full((2,), 999, dtype=torch.long)
        x2d = x[..., :2]
        denoise = port.pose_estimator.denoise
        plain = denoise(x2d, x_t, t)
        mirrored = denoise(joint_flip(x2d), joint_flip(x_t), t)
    want = ((plain + joint_flip(mirrored)) / 2).clamp(-1.1, 1.1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_eval_predict_through_tta_forward_matches_jax(pair):
    """The eval protocol's forward takes the model's `eval_predict` in place
    of the generic flip-TTA: the proposals' mean at the last step, JAX's
    with JAX's default draws (key 0) injected; on its own generator (seed
    0) it is what `tta_forward` returns."""
    jmodel, params, port = pair
    want = np.asarray(jax.jit(lambda p, x: jmodel.eval_predict(p, {}, x))(
        params, jnp.asarray(X)))
    draws = jax_draws(jax.random.key(0), (2, 1, 27, 17, 3), 1)
    got = tta_forward(port, _t(X), flip=True)
    with torch.inference_mode():
        injected = port.sample(_t(X), noise=draws)[:, -1].mean(dim=1)
        direct = port.sample(_t(X))[:, -1].mean(dim=1)
    np.testing.assert_allclose(injected.numpy(), want, **TOL)
    assert got.shape == (2, 27, 17, 3) and torch.equal(got, direct)


def test_carrier_round_trips_through_the_jax_converter():
    port = D3DP(D3DPConfig(**SMALL))
    port.reset_parameters(torch.Generator().manual_seed(5))
    sd = port.state_dict()
    params, state = d3dp_state_dict_to_params(sd, depth=2)
    back = d3dp_state_dict_from_jax(jax.tree.map(np.asarray, params), state)
    assert set(back) == set(sd) and all(k.startswith("pose_estimator.") for k in sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key
    D3DP(D3DPConfig(**SMALL)).load_state_dict(back, strict=True)


def test_full_width_parameter_count_matches_jax():
    """D3DP's -cs 512 -dep 8 (the config's defaults): shapes only."""
    jmodel = jd3dp.D3DP(jd3dp.D3DPConfig())
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))[0]
    with torch.device("meta"):
        port = D3DP(D3DPConfig())
    assert port.parameter_count() == jmodel.parameter_count(shapes)


def test_lift_service_serves_d3dp_on_cpu(pair):
    """`build_model` builds D3DP from a Config; behind `LiftService` it lifts
    a 40-frame track to root-zeroed poses through its own eval forward."""
    port = build_model(Config(model_name="D3DP", n_layers=2, dim_feat=32,
                              num_heads=4, mlp_ratio=2.0), device="cpu")
    assert isinstance(port, D3DP) and port.cfg.flip_tta
    port.load_state_dict(pair[2].state_dict(), strict=True)
    kpts = RNG.uniform(0, 1000, (40, 17, 2)).astype(np.float32)
    service = LiftService(port, device="cpu")
    poses = service.lift_sequence(kpts, 1280, 720)
    assert poses.shape == (40, 17, 3) and np.isfinite(poses).all()
    assert np.abs(poses[:, 0]).max() == 0.0
    assert float(np.abs(poses[:, 1:]).max()) > 1e-3


def jax_train_draws(key: jax.Array, shape: tuple, timesteps: int = 1000):
    """The JAX train forward's draws from the key `make_grads_fn` hands
    `train_predict` (`apply(train=True)`: `kt, kn = split(key)`, t from kt,
    the noise from kn), as the port's tensors."""
    kt, kn = jax.random.split(key)
    t = jax.random.randint(kt, (shape[0],), 0, timesteps)
    return _t(t).long(), _t(jax.random.normal(kn, shape, jnp.float32))


def _train_batch(b: int):
    rng = np.random.default_rng(52)
    x = rng.uniform(-1, 1, (b, 27, 17, 3)).astype(np.float32)
    y = (0.3 * rng.standard_normal((b, 27, 17, 3))).astype(np.float32)
    w = np.ones(b, np.float32)
    w[-1] = 0.0  # a padded clip
    return x, y - y[:, :, :1], w


@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_grads_match_jax_make_grads_fn(pair, microbatch):
    """The diffusion objective through `make_grads_fn`, full batch and in
    two microbatches of 2 (each its own draws: JAX splits the step's key
    once per microbatch), JAX's draws injected into the port's
    `train_predict`: the loss components within 1e-5 relative and every
    parameter's gradient within GRAD_TOL of JAX's, carried into the torch
    layout by the port's own weight carrier. D3DP has no batch norm, so no
    bias's true gradient cancels to zero and none is held otherwise."""
    jmodel, params, port = pair
    x, y, w = _train_batch(4)
    key = jax.random.key(21)
    cfg = JConfig(batch_size=4, flip=False, grad_microbatch=microbatch)
    grads, want_c, _ = jax.jit(JL.make_grads_fn(jmodel, cfg))(params, {}, x, y, w, key)
    want_g = d3dp_state_dict_from_jax(jax.tree.map(np.asarray, grads), {})

    keys = jax.random.split(key, 2) if microbatch else [key]
    draws = iter([jax_train_draws(k, (4 // len(keys), 27, 17, 3)) for k in keys])

    def injected(xc, yc, generator=None):
        t, noise = next(draws)
        return D3DP.train_predict(port, xc, yc, t=t, noise=noise)

    port.zero_grad(set_to_none=True)
    port.train_predict = injected
    try:
        got_c = make_grads_fn(port, Config(batch_size=4, flip=False,
                                           grad_microbatch=microbatch))(
            *(torch.from_numpy(a) for a in (x, y, w)))
    finally:
        del port.train_predict
        port.eval()
    assert next(draws, None) is None  # one draw a microbatch, all used
    assert set(got_c) == set(want_c)
    for k, v in want_c.items():
        assert got_c[k].item() == pytest.approx(float(v), rel=1e-5), k
    named = dict(port.named_parameters())
    assert set(named) <= set(want_g)
    for n, p in named.items():
        assert p.grad is not None, n
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(), **GRAD_TOL,
                                   err_msg=n)
    port.zero_grad(set_to_none=True)


def test_train_forward_is_the_denoised_pose(pair):
    """The train forward is one denoised pose a clip, (B, F, 17, 3), not the
    sampler's (B, steps, H, F, 17, 3): the loss then sees motion, so its
    velocity term is not zero."""
    port = pair[2]
    x, y, w = _train_batch(3)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        pred = port.train_predict(_t(x), _t(y), gen)
    assert pred.shape == (3, 27, 17, 3) and torch.isfinite(pred).all()
    comps = make_grads_fn(port, Config(batch_size=3, flip=False, grad_microbatch=0))(
        _t(x), _t(y), _t(w), torch.Generator().manual_seed(3))
    port.zero_grad(set_to_none=True)
    port.eval()
    assert comps["loss_velocity"].item() > 1e-3


def test_train_predict_draws_from_its_generator(pair):
    """Without injected draws `train_predict` takes t, then the noise, from
    its generator: the same seed gives the same pose, and so do those draws
    made by hand and injected; another seed gives another."""
    port = pair[2]
    x, y, _ = _train_batch(2)
    with torch.no_grad():
        a = port.train_predict(_t(x), _t(y), torch.Generator().manual_seed(5))
        b = port.train_predict(_t(x), _t(y), torch.Generator().manual_seed(5))
        c = port.train_predict(_t(x), _t(y), torch.Generator().manual_seed(6))
        gen = torch.Generator().manual_seed(5)
        t = torch.randint(0, 1000, (2,), generator=gen)
        noise = torch.randn((2, 27, 17, 3), generator=gen)
        d = port.train_predict(_t(x), _t(y), t=t, noise=noise)
    assert torch.equal(a, b) and torch.equal(a, d) and not torch.equal(a, c)
