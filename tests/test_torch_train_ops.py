"""The training path's kernel modules and numerics against the JAX package,
on the CPU: the plain backward versions of K2 (masked attention) and K4
(LN-folded MLP tail) and the port's autograd against `jax.vjp` of the XLA
formulations and the Pallas backward kernels (interpret mode); the losses
(with `_safe_norm`'s zero gradient and NaN propagation), the metrics, the
epoch plan, the flip augmentation and the de-normalisation. The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kasportsformer_tpu.data import pipeline as JP
from kasportsformer_tpu.ops.attention import masked_sdpa_bwd_pallas, masked_sdpa_xla
from kasportsformer_tpu.ops.mlp import _mlp_ln_xla, fused_mlp_ln_bwd_pallas
from kasportsformer_tpu.train import losses as JLS
from kasportsformer_tpu.train import metrics as JM
from kasportsformer_tpu.train.evaluator import denormalize_device as jax_denorm
from kasportsformer_tpu.utils.common import joint_flip as jax_joint_flip
from kasportsformer_torch.data import pipeline as TP
from kasportsformer_torch.ops.attention import (
    masked_sdpa,
    masked_sdpa_bwd,
    masked_sdpa_bwd_reference,
)
from kasportsformer_torch.ops.mlp import (
    _gelu_grad,
    fused_mlp_ln,
    fused_mlp_ln_bwd,
    fused_mlp_ln_bwd_partition,
    fused_mlp_ln_bwd_reduce,
    fused_mlp_ln_bwd_reduce_reference,
    fused_mlp_ln_bwd_reference,
)
from kasportsformer_torch.train import losses as TLS
from kasportsformer_torch.train import metrics as TM
from kasportsformer_torch.train.evaluator import denormalize_device

RNG = np.random.default_rng(31)
# small shapes gain nothing from intra-op threads: leave the cores to the
# suite's other workers
torch.set_num_threads(1)
# float32 on the CPU, both sides: summation order only
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


# ------------------------------------------------------------ K2


def _jax_sdpa_vjp(q, k, v, g, scale, heads):
    @jax.jit
    def vjp(q, k, v, g):
        return jax.vjp(lambda a, b, c: masked_sdpa_xla(a, b, c, scale, heads),
                       q, k, v)[1](g)

    return [np.asarray(z) for z in vjp(q, k, v, g)]


@pytest.mark.parametrize("n,heads,d", [
    pytest.param(17, 8, 16, id="17-8"), pytest.param(27, 8, 16, id="27-8"),
    pytest.param(1, 8, 16, id="1-8"), pytest.param(32, 8, 16, id="32-8"),
    pytest.param(17, 5, 16, id="17-5"),
    pytest.param(17, 8, 32, id="17-8-d32"), pytest.param(27, 8, 32, id="27-8-d32"),
    pytest.param(17, 8, 64, id="17-8-d64"), pytest.param(27, 8, 64, id="27-8-d64"),
    pytest.param(17, 8, 8, id="17-8-d8"), pytest.param(27, 8, 8, id="27-8-d8"),
    pytest.param(1, 8, 8, id="1-8-d8"), pytest.param(32, 8, 8, id="32-8-d8"),
    pytest.param(17, 5, 8, id="17-5-d8"), pytest.param(27, 12, 8, id="27-12-d8")])
def test_masked_sdpa_bwd_reference_matches_jax(n, heads, d):
    """The plain backward against `jax.vjp(masked_sdpa_xla)` and the Pallas
    backward kernel (interpret mode), in the kernel's head widths: heads of
    16 (the flagship) at the spatial (17) and temporal (27) lengths, the
    shortest and longest N the kernel takes, and 5 heads (C = 80), a last
    head group of one head; 8 heads of 32 (DSTFormer, C = 256) and of 64
    (MixSTE, C = 512) at both lengths; heads of 8 (MotionAGFormer-XS and
    hierarchical, C = 64: the kernel's tile of eight heads) at both lengths,
    the shortest and longest N, and the short last groups of that tile, 5
    heads (C = 40) and 12 (C = 96: a group of eight, then one of four).
    These are the shapes at which the card tests hold the kernel to this
    plain version. float32 on both sides: within atol 1e-5, rtol 1e-4.
    Heads of 8 draw from a generator of their own, so the file's other
    tests keep their inputs."""
    c = d * heads
    rng = np.random.default_rng(800 + 100 * n + heads) if d == 8 else RNG
    q, k, v, g = (rng.standard_normal((1, 3, n, c)).astype(np.float32)
                  for _ in range(4))
    got = masked_sdpa_bwd_reference(_t(q), _t(k), _t(v), _t(g), 0.25, heads)
    want = _jax_sdpa_vjp(q, k, v, g, 0.25, heads)
    kernel = masked_sdpa_bwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(g), 0.25, heads,
                                    interpret=True)
    for a, w, p in zip(got, want, kernel):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(a.numpy(), np.asarray(p), atol=1e-5, rtol=1e-4)


def _bf16_scaled_err(got: torch.Tensor, want: np.ndarray) -> float:
    a = got.float().numpy()
    return float((np.abs(a - want) / np.maximum(np.abs(want), 1.0)).max())


@pytest.mark.parametrize("n,heads,d", [
    pytest.param(1, 8, 16, id="1-8"), pytest.param(17, 8, 16, id="17-8"),
    pytest.param(27, 8, 16, id="27-8"), pytest.param(32, 8, 16, id="32-8"),
    pytest.param(17, 5, 16, id="17-5"), pytest.param(27, 5, 16, id="27-5"),
    pytest.param(17, 8, 32, id="17-8-d32"), pytest.param(27, 8, 32, id="27-8-d32"),
    pytest.param(17, 8, 64, id="17-8-d64"), pytest.param(27, 8, 64, id="27-8-d64")])
def test_masked_sdpa_bwd_reference_bf16_rounds_where_the_pallas_kernel_does(n, heads, d):
    """The plain backward in bfloat16 against the Pallas backward kernel in
    bfloat16 (interpret mode): both form S, dP and the three products in
    float32 from the bfloat16 inputs and round P (for dV), dS and the
    results to bfloat16, so they differ only where a sum order moves a
    value across a rounding edge: within 2.5e-3 per element, scaled by
    max(1, |y|). A plain version that computes in float32 throughout and
    rounds only its results lies outside that limit from N = 17 on; at
    N = 1, P is 1 and dS is 0, so nothing rounds and both are exact.
    Inputs from a generator of their own, so the file's other tests keep
    theirs."""
    c = d * heads
    rng = np.random.default_rng(2500 + 100 * n + c)
    q, k, v, g = (rng.standard_normal((1, 3, n, c)).astype(np.float32)
                  for _ in range(4))
    args = [_t(z).to(torch.bfloat16) for z in (q, k, v, g)]
    scale = d ** -0.5
    got = masked_sdpa_bwd_reference(*args, scale, heads)
    control = [z.to(torch.bfloat16) for z in
               masked_sdpa_bwd_reference(*(z.float() for z in args), scale, heads)]
    want = [np.asarray(z, np.float32) for z in masked_sdpa_bwd_pallas(
        *(jnp.asarray(z, jnp.bfloat16) for z in (q, k, v, g)), scale, heads,
        interpret=True)]
    errs = [_bf16_scaled_err(a, w) for a, w in zip(got, want)]
    ctl = [_bf16_scaled_err(a, w) for a, w in zip(control, want)]
    assert all(a.dtype == torch.bfloat16 for a in got)
    assert max(errs) <= 2.5e-3, errs
    if n == 1:
        assert max(errs) == max(ctl) == 0.0, (errs, ctl)
    else:
        assert max(ctl) > 2.5e-3, ctl


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_masked_sdpa_autograd_matches_jax_on_strided_views(mode):
    """The port's autograd through column slices of one qkv projection and
    (temporal) permuted views, as the model differentiates them."""
    b, t, j, c = 1, 27, 17, 128
    qkv = RNG.standard_normal((b, t, j, 3 * c)).astype(np.float32)
    g = RNG.standard_normal((b, t, j, c)).astype(np.float32)
    base = _t(qkv, grad=True)
    q, k, v = base.split(c, dim=-1)
    qn, kn, vn = (qkv[..., i * c:(i + 1) * c] for i in range(3))
    gn = g
    if mode == "temporal":
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))
        qn, kn, vn, gn = (z.transpose(0, 2, 1, 3) for z in (qn, kn, vn, g))
    out = masked_sdpa(q, k, v, 0.25, 8)
    gt = _t(g).transpose(1, 2) if mode == "temporal" else _t(g)
    (dqkv,) = torch.autograd.grad(out, base, gt)
    want = _jax_sdpa_vjp(qn, kn, vn, gn, 0.25, 8)
    if mode == "temporal":
        want = [w.transpose(0, 2, 1, 3) for w in want]
    np.testing.assert_allclose(dqkv.numpy(), np.concatenate(want, -1),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_masked_sdpa_bwd_reference_matches_jax_at_heads_of_8(mode):
    """The plain backward at MotionAGFormer-XS's and hierarchical's 8 heads
    of 8 (C = 64) against `jax.vjp(masked_sdpa_xla)`, the formulation the
    JAX package runs at that width: column slices of one qkv projection on
    (B, T, J, C) and, temporal, their (B, J, T, C) permutation (N = 27) with
    the gradient of that layout. These are the shapes at which the card
    tests hold the kernel to this plain version. float32 on both sides:
    within atol 1e-5, rtol 1e-4. Inputs from a generator of their own, so
    the file's other tests keep theirs."""
    rng = np.random.default_rng(8)
    qkv = rng.standard_normal((2, 27, 17, 192)).astype(np.float32)
    g = rng.standard_normal((2, 27, 17, 64)).astype(np.float32)
    qn, kn, vn = (qkv[..., i * 64:(i + 1) * 64] for i in range(3))
    q, k, v = _t(qkv).split(64, dim=-1)
    gt = _t(g)
    if mode == "temporal":
        qn, kn, vn, g = (z.transpose(0, 2, 1, 3) for z in (qn, kn, vn, g))
        q, k, v, gt = (z.transpose(1, 2) for z in (q, k, v, gt))
    got = masked_sdpa_bwd_reference(q, k, v, gt, 8 ** -0.5, 8)
    for a, w in zip(got, _jax_sdpa_vjp(qn, kn, vn, g, 8 ** -0.5, 8)):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5, rtol=1e-4)


def test_masked_sdpa_bwd_large_interhead_spread():
    """The x60 head-0 spread: the backward stays finite and matches."""
    q, k, v, g = (RNG.standard_normal((1, 4, 17, 128)).astype(np.float32)
                  for _ in range(4))
    q[..., :16] *= 60.0
    k[..., :16] *= 60.0
    got = masked_sdpa_bwd_reference(_t(q), _t(k), _t(v), _t(g), 0.25, 8)
    for a, w in zip(got, _jax_sdpa_vjp(q, k, v, g, 0.25, 8)):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), w, atol=1e-3, rtol=1e-3)


def test_masked_sdpa_bwd_refuses_cpu_tensors():
    """K2's wrapper launches the kernel or raises: no plain fallback."""
    q = torch.zeros(1, 1, 17, 128)
    before = masked_sdpa_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        masked_sdpa_bwd(q, q, q, q, 0.25, 8)
    assert masked_sdpa_bwd.launches == before


# ------------------------------------------------------------ K4


def _mlp_inputs(m: int, c: int = 128, hidden: int = 512, rng=RNG):
    f = np.float32
    return dict(
        x=rng.standard_normal((m, c)).astype(f),
        gamma=(1.0 + 0.1 * rng.standard_normal(c)).astype(f),
        beta=(0.1 * rng.standard_normal(c)).astype(f),
        w1=(rng.standard_normal((c, hidden)) * 0.05).astype(f),  # JAX (in, out)
        b1=(rng.standard_normal(hidden) * 0.05).astype(f),
        w2=(rng.standard_normal((hidden, c)) * 0.05).astype(f),
        b2=(rng.standard_normal(c) * 0.05).astype(f),
        ls2=rng.uniform(0.1, 1.0, c).astype(f),
    )


_ORDER = ("x", "gamma", "beta", "w1", "b1", "w2", "b2", "ls2")


def _torch_mlp_args(a: dict, grad: bool = False):
    """JAX-layout arrays -> the port's arguments (nn.Linear layout)."""
    return tuple(_t(a[k].T if k in ("w1", "w2") else a[k], grad) for k in _ORDER)


def _jax_mlp_grads(a: dict, g: np.ndarray, eps: float = 1e-5) -> list[np.ndarray]:
    """`jax.vjp(_mlp_ln_xla)`, weight gradients turned to the torch layout."""
    vjp = jax.jit(lambda args, g: jax.vjp(
        lambda *r: _mlp_ln_xla(*r, eps=eps), *args)[1](g))
    out = [np.asarray(z) for z in vjp(tuple(a[k] for k in _ORDER), g)]
    out[3], out[5] = out[3].T, out[5].T
    return out


def _check_mlp_bwd_reference(m: int, c: int, hidden: int, eps: float, rng=RNG) -> None:
    """The plain K4 backward against `jax.vjp(_mlp_ln_xla)` and the Pallas
    backward kernel (interpret mode) at this width and LayerNorm eps."""
    a = _mlp_inputs(m, c, hidden, rng)
    g = rng.standard_normal((m, c)).astype(np.float32)
    got = fused_mlp_ln_bwd_reference(*_torch_mlp_args(a), _t(g), eps)
    want = _jax_mlp_grads(a, g, eps)
    kernel = [np.asarray(z) for z in fused_mlp_ln_bwd_pallas(
        *(jnp.asarray(a[k]) for k in _ORDER), jnp.asarray(g), eps=eps, interpret=True)]
    kernel[3], kernel[5] = kernel[3].T, kernel[5].T
    for name, x, w, p in zip(_ORDER, got, want, kernel):
        # parameter gradients sum m rows: relative 1e-5 of their scale
        np.testing.assert_allclose(x.numpy(), w, atol=1e-4, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(x.numpy(), p, atol=1e-4, rtol=1e-5, err_msg=name)


def test_fused_mlp_ln_bwd_reference_matches_jax():
    _check_mlp_bwd_reference(256, 128, 512, 1e-5)


@pytest.mark.parametrize("c,hidden,eps", [(256, 1024, 1e-5), (512, 1024, 1e-6),
                                          (64, 256, 1e-5)])
def test_fused_mlp_ln_bwd_reference_matches_jax_at_zoo_widths(c, hidden, eps):
    """DSTFormer's tail (256/1024), MixSTE's (512/1024, LayerNorm eps 1e-6)
    and MotionAGFormer-XS's and hierarchical's (64/256, where the JAX
    package itself takes `_mlp_ln_xla`: its kernels gate on C % 128 == 0),
    the widths K4 takes beside the flagship's, at 64 rows. The C = 64 case
    draws from a generator of its own, so the file's later tests keep their
    inputs."""
    _check_mlp_bwd_reference(64, c, hidden, eps,
                             np.random.default_rng(c) if c == 64 else RNG)


def test_fused_mlp_ln_autograd_matches_jax_ragged_rows():
    """The port's autograd over (B, T, J, C) input at a row count no
    8-row block divides (3 x 27 x 17 = 1,377)."""
    a = _mlp_inputs(1377)
    g = RNG.standard_normal((1377, 128)).astype(np.float32)
    args = _torch_mlp_args(a, grad=True)
    x4 = args[0].reshape(3, 27, 17, 128)
    out = fused_mlp_ln(x4, *args[1:], 1e-5)
    got = torch.autograd.grad(out, args, _t(g).reshape(out.shape))
    for name, x, w in zip(_ORDER, got, _jax_mlp_grads(a, g)):
        np.testing.assert_allclose(x.numpy(), w, atol=2e-4, rtol=1e-5, err_msg=name)


def test_fused_mlp_ln_bwd_reference_bf16_within_rounding():
    """bf16 plain backward against the JAX bf16 backward kernel (interpret
    mode): both round LN(x), the hidden, do and dz to bf16 and sum in
    float32. The TPU kernel's bf16 GELU and its derivative are the tanh form
    (the value up to 4.8e-4 away), which moves some dz across a bf16
    rounding boundary; the parameter gradients sum 256 such rows. Limit
    5e-2, scaled by max(1, |y|)."""
    a = _mlp_inputs(256)
    g = RNG.standard_normal((256, 128)).astype(np.float32)
    args = [t.to(torch.bfloat16) if i in (0, 3, 4, 5, 6) else t
            for i, t in enumerate(_torch_mlp_args(a))]
    got = fused_mlp_ln_bwd_reference(*args, _t(g).to(torch.bfloat16))
    jargs = [jnp.asarray(a[k]) for k in _ORDER]
    for i in (0, 3, 4, 5, 6):
        jargs[i] = jargs[i].astype(jnp.bfloat16)
    want = [np.asarray(z, np.float32) for z in fused_mlp_ln_bwd_pallas(
        *jargs, jnp.asarray(g, jnp.bfloat16), interpret=True)]
    want[3], want[5] = want[3].T, want[5].T
    for name, x, w in zip(_ORDER, got, want):
        err = np.abs(x.float().numpy() - w) / np.maximum(np.abs(w), 1.0)
        assert float(err.max()) < 5e-2, (name, float(err.max()))


def test_fused_mlp_ln_bwd_refuses_cpu_tensors():
    args = _torch_mlp_args(_mlp_inputs(8))
    before = fused_mlp_ln_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_ln_bwd(*args, args[0])
    assert fused_mlp_ln_bwd.launches == before


def _gelu_tanh_and_grad(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GELU and GELU' in the tanh form of the TPU kernel's bfloat16 path
    (`_mlp_ln_bwd_kernel`): sig = (1 + tanh(z u)) / 2, u = c (1 + 0.044715
    z^2), GELU = z sig, GELU' = sig + z sig (1 - sig) (2c + 6c 0.044715 z^2)."""
    c = 0.7978845608
    s = z * z
    sig = 0.5 * (1.0 + torch.tanh(z * (c * 0.044715 * s + c)))
    return z * sig, sig + z * (sig * (1.0 - sig)) * (3 * (2 * c * 0.044715) * s + 2 * c)


def _k4_workspace(args, g: torch.Tensor, eps: float = 1e-5,
                  bf16: bool = False, tanh: bool = False) -> torch.Tensor:
    """The workspace K4's two passes leave, built in plain float32 torch over
    their partition: a dx partial (sum da * xhat, sum da, sum g) a dx tile
    (112 rows at C = 128), then a weight partial (dW1 = dz^T a, G = g^T h,
    db1 = sum dz) a row split of consecutive weight-pass tiles (56 rows at
    C = 64, 40 at 128, 48 at 256, 32 at 512; an empty split's zeros). With
    bf16, as the tensor-core passes at C = 128 build it from bfloat16
    operands: a = LN(x) gamma + beta, h, do = g ls2 and dz rounded to
    bfloat16 (da and dW1 from the rounded dz, db1 from dz before its
    rounding, G from g, exact in bfloat16). With tanh, GELU and GELU' in
    the TPU kernel's bfloat16 tanh form in place of the erf form."""
    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).float() if bf16 else t

    x, gamma, beta, w1, b1, w2, b2, ls2 = (t.float() for t in args)
    m, c = x.shape
    hidden = w1.shape[0]
    mean = x.mean(-1, keepdim=True)
    xhat = (x - mean) * torch.rsqrt((x - mean).square().mean(-1, keepdim=True) + eps)
    a = rnd(xhat * gamma + beta)
    z = a @ w1.t() + b1
    gelu, grad = (_gelu_tanh_and_grad(z) if tanh else
                  (torch.nn.functional.gelu(z), _gelu_grad(z)))
    h = rnd(gelu)
    dz = rnd(g * ls2) @ w2 * grad
    dzb = rnd(dz)
    da = dzb @ w1
    p = fused_mlp_ln_bwd_partition(m, hidden, c)
    parts = []
    for n in range(p["dx_tiles"]):
        r = slice(n * p["dx_rows"], (n + 1) * p["dx_rows"])
        parts.append(torch.stack([(da[r] * xhat[r]).sum(0), da[r].sum(0), g[r].sum(0)]))
    rows = p["per_split"] * p["w_rows"]
    for s in range(p["splits"]):
        r = slice(s * rows, (s + 1) * rows)
        parts.append(torch.cat([(dzb[r].t() @ a[r]).reshape(-1),
                                (g[r].t() @ h[r]).reshape(-1), dz[r].sum(0)]))
    return torch.cat([t.reshape(-1) for t in parts])


@pytest.mark.parametrize("m,tiles", [(300, (3, 8)), (1377, (13, 16)), (39, (1, 1)),
                                     (41, (1, 2))])
def test_fused_mlp_ln_bwd_reduce_reference_bf16_tensor_core_partials(m, tiles):
    """bf16 at C = 128: the reduce's plain version on partials built as the
    tensor-core passes build them (a, h, do and dz rounded to bfloat16,
    G = g^T h), over K4's partition (dx tiles, weight splits): a ragged
    M = 300, the step's ragged 1,377, and one row either side of a 40-row
    weight tile (39, 41). Against JAX's bf16 backward kernel (interpret
    mode) on the rows padded with zeros to a multiple of 64, rows that add
    nothing to the parameter gradients (g = 0, so dz = 0): within 1e-2 of
    each gradient's largest entry, K4's bf16 limit on the card, and per
    element, scaled by max(1, |y|), within 1e-1. Per element the 5e-2 of
    the other K4 cases does not hold, for two causes that the same partials
    in the TPU kernel's tanh GELU tell apart: the GELU form (the erf
    partials up to 3.5e-2 from the kernel on dW1, the tanh ones within
    5e-2, held, on dgamma, dbeta, dW1, db1 and dls2), and dW2 = ls2 G, db2 =
    ls2 sum g from g, where the TPU kernel sums bf16(g ls2) (up to 6.1e-2 on
    dW2 and db2 in either form, at M = 1,377; the plain version, which
    rounds do as the kernel does, 5.1e-2 on dW2 and 3.3e-3 on db2;
    scripts/k4_bf16_jax_readings.py prints them). Against
    the port's plain version in bfloat16: dgamma, dbeta,
    dW1, db1 and dls2 within float32 summation order (1e-4 absolute, 1e-5
    relative); dW2 = ls2 G and db2 = ls2 sum g, which the plain version
    takes from do rounded to bfloat16, within that rounding, 2^-8 of their
    largest entry. Inputs from a generator of their own."""
    rng = np.random.default_rng(1000 + m)
    a = _mlp_inputs(m, 128, 512, rng)
    g = rng.standard_normal((m, 128)).astype(np.float32)
    args = [t.to(torch.bfloat16) if i in (0, 3, 4, 5, 6) else t
            for i, t in enumerate(_torch_mlp_args(a))]
    gb = _t(g).to(torch.bfloat16)
    p = fused_mlp_ln_bwd_partition(m, 512)
    assert (p["dx_tiles"], p["splits"], p["w_rows"]) == (*tiles, 40)
    got, tanh = (fused_mlp_ln_bwd_reduce_reference(
        _k4_workspace(args, gb.float(), bf16=True, tanh=t), *args[5:], m) for t in (False, True))
    pad = -m % 64
    jargs = [jnp.asarray(a[k]) for k in _ORDER]
    jargs[0] = jnp.pad(jargs[0], ((0, pad), (0, 0)))
    for i in (0, 3, 4, 5, 6):
        jargs[i] = jargs[i].astype(jnp.bfloat16)
    kernel = [np.asarray(z, np.float32) for z in fused_mlp_ln_bwd_pallas(
        *jargs, jnp.pad(jnp.asarray(g, jnp.bfloat16), ((0, pad), (0, 0))), interpret=True)]
    kernel[3], kernel[5] = kernel[3].T, kernel[5].T
    plain = fused_mlp_ln_bwd_reference(*args, gb)
    for name, x, xt, w, q in zip(_ORDER[1:], got, tanh, kernel[1:], plain[1:]):
        err = np.abs(x.numpy() - w).max() / np.abs(w).max()
        assert float(err) <= 1e-2, (name, float(err))
        for y, lim in ((x, 1e-1), (xt, 1e-1 if name in ("w2", "b2") else 5e-2)):
            per = np.abs(y.numpy() - w) / np.maximum(1.0, np.abs(w))
            assert float(per.max()) <= lim, (name, lim, float(per.max()))
        if name in ("w2", "b2"):
            assert (x - q).abs().max() <= 2 ** -8 * q.abs().max(), name
        else:
            np.testing.assert_allclose(x.numpy(), q.numpy(), atol=1e-4, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("m,hidden,c,eps", [
    pytest.param(300, 128, 128, 1e-5, id="300-128"),
    pytest.param(1377, 512, 128, 1e-5, id="1377-512"),
    pytest.param(320, 128, 128, 1e-5, id="320-128"),
    pytest.param(300, 1024, 256, 1e-5, id="300-1024-c256"),
    pytest.param(300, 1024, 512, 1e-6, id="300-1024-c512"),
    pytest.param(111, 1024, 256, 1e-5, id="111-1024-c256"),
    pytest.param(113, 1024, 256, 1e-5, id="113-1024-c256"),
    pytest.param(55, 1024, 512, 1e-6, id="55-1024-c512"),
    pytest.param(57, 1024, 512, 1e-6, id="57-1024-c512"),
    pytest.param(300, 256, 64, 1e-5, id="300-256-c64"),
    pytest.param(113, 256, 64, 1e-5, id="113-256-c64")])
def test_fused_mlp_ln_bwd_reduce_reference_matches_jax(m, hidden, c, eps):
    """The reduce's plain version on partials built over K4's own partition
    (a ragged M = 300 at H = 128: 3 dx tiles, 8 splits of one 40-row tile;
    M = 1,377 at H = 512: 13 dx tiles, 16 splits of 3 tiles, the last four
    empty; M = 320, a multiple of 8; M = 300 at the zoo's widths: DSTFormer's
    256/1024, 3 dx tiles of the cluster's 112 rows and 4 splits of two of
    the weight pass's 48-row tiles, the last with one, and MixSTE's
    512/1024 at eps 1e-6, 6 dx tiles of 56 rows and 2 splits of 5 32-row
    tiles; and one row either side of a dx tile at both: M = 111 and 113 at
    256/1024, 55 and 57 at 512/1024; at MotionAGFormer's 64/256, M = 300,
    3 dx tiles of 112 rows and 6 splits of one 56-row tile, and 113, one
    row past a dx tile, from a generator of their own so that the file's
    later tests keep their inputs) against the JAX package's K4
    gradients."""
    _check_reduce_reference(m, hidden, c, eps, {
        (300, 128): (3, 8, 0), (1377, 128): (13, 16, 4), (320, 128): (3, 8, 0),
        (300, 256): (3, 4, 0), (300, 512): (6, 2, 0), (111, 256): (1, 3, 0),
        (113, 256): (2, 3, 0), (55, 512): (1, 2, 0), (57, 512): (2, 2, 0),
        (300, 64): (3, 6, 0), (113, 64): (2, 3, 0)}[m, c],
        np.random.default_rng(m * c) if c == 64 else RNG)


@pytest.mark.parametrize("m,c,eps", [
    (47, 256, 1e-5), (49, 256, 1e-5), (191, 256, 1e-5), (193, 256, 1e-5),
    (31, 512, 1e-6), (33, 512, 1e-6), (63, 512, 1e-6), (65, 512, 1e-6),
    (55, 64, 1e-5), (57, 64, 1e-5), (895, 64, 1e-5), (897, 64, 1e-5)])
def test_fused_mlp_ln_bwd_reduce_reference_matches_jax_at_weight_pass_edges(m, c, eps):
    """As above at H = 1,024, one row either side of a weight-pass tile of
    the cluster pass (48 rows at C = 256, 32 at 512: M = 47 and 49, 31 and
    33) and of its splits of one tile each (4 splits at 256, 2 at 512: M =
    191 and 193, 63 and 65; the last of 193's splits empty); at C = 64, of
    the one-block pass's 56-row tile (M = 55 and 57) and of its 16 splits of
    one tile (8 hidden chunks of 128: M = 895 and 897, the second 17 tiles
    over splits of two, the last seven empty). Inputs from a generator of
    their own, so the file's other tests keep theirs."""
    _check_reduce_reference(m, 1024, c, eps, {
        (47, 256): (1, 1, 0), (49, 256): (1, 2, 0), (191, 256): (2, 4, 0),
        (193, 256): (2, 4, 1), (31, 512): (1, 1, 0), (33, 512): (1, 2, 0),
        (63, 512): (2, 2, 0), (65, 512): (2, 2, 0), (55, 64): (1, 1, 0),
        (57, 64): (1, 2, 0), (895, 64): (8, 16, 0), (897, 64): (9, 16, 7)}[m, c],
        np.random.default_rng(m * c))


def _check_reduce_reference(m: int, hidden: int, c: int, eps: float, tiles: tuple,
                            rng) -> None:
    """The reduce's plain version on partials built over K4's partition for
    m rows, whose (dx tiles, weight splits, empty splits) must be `tiles`,
    against `jax.vjp(_mlp_ln_xla)` and, where its row blocks divide m (a
    multiple of 8), the Pallas backward kernel (interpret mode)."""
    a = _mlp_inputs(m, c, hidden, rng)
    g = rng.standard_normal((m, c)).astype(np.float32)
    args = _torch_mlp_args(a)
    p = fused_mlp_ln_bwd_partition(m, hidden, c)
    empty = p["splits"] - -(-(-(-m // p["w_rows"])) // p["per_split"])
    assert (p["dx_tiles"], p["splits"], empty) == tiles
    got = fused_mlp_ln_bwd_reduce_reference(_k4_workspace(args, _t(g), eps),
                                            *args[5:], m)
    wants = [_jax_mlp_grads(a, g, eps)[1:]]
    if m % 8 == 0:
        kernel = [np.asarray(z) for z in fused_mlp_ln_bwd_pallas(
            *(jnp.asarray(a[k]) for k in _ORDER), jnp.asarray(g), eps=eps,
            interpret=True)]
        kernel[3], kernel[5] = kernel[3].T, kernel[5].T
        wants.append(kernel[1:])
    for want in wants:
        for name, x, w in zip(_ORDER[1:], got, want):
            np.testing.assert_allclose(x.numpy(), w, atol=1e-4, rtol=1e-5, err_msg=name)


def test_fused_mlp_ln_bwd_reduce_refuses_cpu_tensors():
    """The reduce alone launches its kernel or raises: no plain fallback."""
    args = _torch_mlp_args(_mlp_inputs(8))
    p = fused_mlp_ln_bwd_partition(8, 512)
    work = torch.zeros(p["dx_tiles"] * 3 * 128 + p["splits"] * (2 * 512 * 128 + 512))
    before = fused_mlp_ln_bwd_reduce.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_ln_bwd_reduce(work, *args[5:], 8)
    assert fused_mlp_ln_bwd_reduce.launches == before


# ------------------------------------------------------------ losses


def _poses(b: int = 3, t: int = 27) -> tuple[np.ndarray, np.ndarray]:
    return (RNG.standard_normal((b, t, 17, 3)).astype(np.float32),
            RNG.standard_normal((b, t, 17, 3)).astype(np.float32))


_LOSSES = ["mpjpe_loss", "n_mpjpe_loss", "velocity_loss", "limb_length_loss",
           "cos_similarity_loss", "cos_similarity_velocity_loss", "weighted_mpjpe"]


@pytest.mark.parametrize("name", _LOSSES + ["limb_length_variance_loss"])
def test_loss_and_gradient_match_jax(name):
    p, t = _poses()
    if name in ("mpjpe_loss", "velocity_loss", "weighted_mpjpe"):
        # exact zeros under the norm; in the limb losses they would sit
        # under an abs, whose subgradient at 0 the two frameworks choose
        # differently
        p[0, 3] = t[0, 3]  # a zero distance
        p[1, 4] = p[1, 3]  # a zero velocity difference
        t[1, 4] = t[1, 3]
    jfn, tfn = getattr(JLS, name), getattr(TLS, name)
    if name == "limb_length_variance_loss":
        jfn1, tfn1 = jfn, tfn
        jfn, tfn = (lambda a, b: jfn1(a)), (lambda a, b: tfn1(a))
    want, jgrad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(p), jnp.asarray(t))
    tp = _t(p, grad=True)
    got = tfn(tp, _t(t))
    (tgrad,) = torch.autograd.grad(got, tp)
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    assert np.isfinite(tgrad.numpy()).all()
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=1e-4)


def test_safe_norm_zero_gradient_and_nan_propagation():
    x = torch.tensor([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0], [float("nan"), 0.0, 0.0]],
                     requires_grad=True)
    n = TLS._safe_norm(x)
    assert n[0].item() == 0.0 and n[1].item() == 5.0 and torch.isnan(n[2])
    (g,) = torch.autograd.grad(n[:2].sum(), x)
    np.testing.assert_array_equal(g[0].numpy(), 0.0)  # 0 at an exact zero
    np.testing.assert_allclose(g[1].numpy(), [0.6, 0.8, 0.0])
    want = np.asarray(JLS._safe_norm(jnp.asarray(x.detach().numpy())))
    np.testing.assert_array_equal(n.detach().numpy(), want)


@pytest.mark.parametrize("lambdas", [(0.5, 20.0, 0, 0, 0, 0), (0.5, 20.0, 1, 2, 3, 4)])
def test_total_loss_matches_jax(lambdas):
    p, t = _poses()
    want_total, want = JLS.total_loss(jnp.asarray(p), jnp.asarray(t), *lambdas)
    got_total, got = TLS.total_loss(_t(p), _t(t), *lambdas)
    assert set(got) == set(want)
    for key in want:
        assert got[key].item() == pytest.approx(float(want[key]), rel=1e-5), key


# ------------------------------------------------------------ metrics


@pytest.mark.parametrize("name", ["mpjpe", "jpe", "acceleration_error", "p_mpjpe"])
def test_metric_matches_jax(name):
    p, t = _poses(b=1)
    want = np.asarray(getattr(JM, name)(jnp.asarray(p[0]), jnp.asarray(t[0])))
    got = getattr(TM, name)(_t(p[0]), _t(t[0])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_clip_metrics_batched_match_jax_and_fix_reflections():
    """A batch of clips at once, one of them a mirrored copy of its target
    (det R < 0 before the fix): P-MPJPE of a mirror image is not 0."""
    p, t = _poses(b=4)
    p[0] = t[0] * np.array([-1.0, 1.0, 1.0], np.float32)
    want = JM.batched_clip_metrics(jnp.asarray(p), jnp.asarray(t))
    got = TM.clip_metrics(_t(p), _t(t))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
    aligned = _t(t[1:2] * 2.0 + 1.0)  # scale + shift of the target
    assert TM.p_mpjpe(aligned, _t(t[1:2])).abs().max().item() < 1e-4


# ------------------------------------------------------------ data, eval


@pytest.mark.parametrize("n,batch", [(45, 8), (64, 32), (7, 16)])
def test_epoch_plan_identical_to_jax(n, batch):
    for epoch in range(3):
        want = JP.epoch_plan(n, batch, np.random.default_rng([114514, epoch]))
        got = TP.epoch_plan(n, batch, np.random.default_rng([114514, epoch]))
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.weights, want.weights)
        assert got.steps == want.steps
    seq = TP.epoch_plan(n, batch)
    np.testing.assert_array_equal(seq.indices, JP.epoch_plan(n, batch).indices)


def test_random_flip_batch_matches_jax_for_a_given_mask():
    x, y = _poses(b=6)
    mask = np.array([True, False, True, True, False, False])
    mj = jnp.asarray(mask)[:, None, None, None]
    want_x = np.where(mask[:, None, None, None],
                      np.asarray(jax_joint_flip(jnp.asarray(x))), x)
    want_y = np.asarray(jnp.where(mj, jax_joint_flip(jnp.asarray(y)), y))
    gx, gy = TP.random_flip_batch(_t(x), _t(y), mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(gx.numpy(), want_x)
    np.testing.assert_array_equal(gy.numpy(), want_y)


def test_flip_generator_replays_per_step():
    """The mask of a step depends on (seed, epoch, step) alone, so a resumed
    run draws the flips of an uninterrupted one; about half are flipped."""
    def mask(seed, epoch, step):
        return torch.rand(256, generator=TP.flip_generator(seed, epoch, step)) < 0.5

    assert torch.equal(mask(1, 2, 3), mask(1, 2, 3))
    assert not torch.equal(mask(1, 2, 3), mask(1, 2, 4))
    assert not torch.equal(mask(1, 2, 3), mask(1, 3, 3))
    assert 0.35 < mask(1, 2, 3).float().mean().item() < 0.65


def test_take_batch_and_truncate_channels():
    x, _ = _poses(b=5)
    idx = np.array([4, 0, 4], np.int32)
    got = TP.take_batch(_t(x), idx)
    np.testing.assert_array_equal(got.numpy(), x[idx])
    assert TP.truncate_channels(got, 2).shape[-1] == 2
    assert TP.truncate_channels(got, 3) is got


def test_denormalize_device_matches_jax_with_res_as_width_height():
    p, _ = _poses(b=3)
    res = np.array([[1920, 1080], [1280, 720], [1000, 1000]], np.float32)
    want = np.asarray(jax_denorm(jnp.asarray(p), jnp.asarray(res)))
    got = denormalize_device(_t(p), _t(res)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # x is scaled by W/2 around W/2; y by W/2 around H/2
    np.testing.assert_allclose(got[0, 0, 0, 0], (p[0, 0, 0, 0] + 1) * 960, rtol=1e-6)
    np.testing.assert_allclose(got[0, 0, 0, 1], (p[0, 0, 0, 1] + 1080 / 1920) * 960,
                               rtol=1e-6)
