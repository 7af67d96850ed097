"""kasportsformer_torch's zoo (MotionAGFormer in its four variants, MixSTE,
DSTFormer, STCFormer, KTPFormer; D3DP has `test_torch_d3dp.py`) and the
layers it brought against the JAX package, on the CPU in float32 with the
same numpy-drawn weights loaded into both: per module, the eight models at a
small width, the parameter counts at full width, and the weight carriers'
round trip through the JAX package's converters."""

import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kasportsformer_tpu.models import layers as JL
from kasportsformer_tpu.models.zoo import ktpformer as jktp
from kasportsformer_tpu.models.zoo import stcformer as jstc
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
from kasportsformer_tpu.train.checkpoint import (
    dstformer_state_dict_to_params,
    ktpformer_state_dict_to_params,
    mixste_state_dict_to_params,
    motionagformer_state_dict_to_params,
    stcformer_state_dict_to_params,
)
from kasportsformer_torch.config import Config
from kasportsformer_torch.models import layers as TL
from kasportsformer_torch.models.zoo.dstformer import DSTFormer, DSTFormerConfig
from kasportsformer_torch.models.zoo.ktpformer import KTPFormer, KTPFormerConfig
from kasportsformer_torch.models.zoo.mixste import MixSTE, MixSTEConfig
from kasportsformer_torch.models.zoo.motionagformer import (
    MotionAGFormer,
    MotionAGFormerConfig,
)
from kasportsformer_torch.models.zoo.stcformer import STCFormer, STCFormerConfig
from kasportsformer_torch.serving import LiftService
from kasportsformer_torch.train.checkpoint import (
    dstformer_state_dict_from_jax,
    ktpformer_state_dict_from_jax,
    mixste_state_dict_from_jax,
    motionagformer_state_dict_from_jax,
    stcformer_state_dict_from_jax,
)
from kasportsformer_torch.train.loop import make_grads_fn
from torch_parity import perturb_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(31)
# small shapes gain nothing from intra-op threads: leave the cores to the
# suite's other workers
torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)

_MAG = dict(n_layers=2, dim_feat=32, dim_rep=64, num_heads=4)
# name -> (JAX class, JAX config, port class, port config, carrier, the JAX
# converter's keyword arguments); width 32, 2-3 layers, 4 heads
FAMILIES = {
    "mag_base": (JaxMotionAGFormer, JaxMotionAGFormerConfig(**_MAG),
                 MotionAGFormer, MotionAGFormerConfig(**_MAG),
                 motionagformer_state_dict_from_jax, dict(n_layers=2)),
    "mag_tcn": (JaxMotionAGFormer, JaxMotionAGFormerConfig(**_MAG, use_tcn=True),
                MotionAGFormer, MotionAGFormerConfig(**_MAG, use_tcn=True),
                motionagformer_state_dict_from_jax, dict(n_layers=2, use_tcn=True)),
    "mag_hierarchical": (
        JaxMotionAGFormer, JaxMotionAGFormerConfig(**_MAG, hierarchical=True),
        MotionAGFormer, MotionAGFormerConfig(**_MAG, hierarchical=True),
        motionagformer_state_dict_from_jax, dict(n_layers=2, hierarchical=True)),
    "mag_graph_only": (
        JaxMotionAGFormer, JaxMotionAGFormerConfig(**_MAG, graph_only=True),
        MotionAGFormer, MotionAGFormerConfig(**_MAG, graph_only=True),
        motionagformer_state_dict_from_jax, dict(n_layers=2, graph_only=True)),
    "mixste": (JaxMixSTE, JaxMixSTEConfig(embed_dim=32, depth=3, num_heads=4),
               MixSTE, MixSTEConfig(embed_dim=32, depth=3, num_heads=4),
               mixste_state_dict_from_jax, dict(depth=3)),
    "dstformer": (JaxDSTFormer, JaxDSTFormerConfig(dim_feat=32, dim_rep=64, depth=2,
                                                   num_heads=4, mlp_ratio=2.0),
                  DSTFormer, DSTFormerConfig(dim_feat=32, dim_rep=64, depth=2,
                                             num_heads=4, mlp_ratio=2.0),
                  dstformer_state_dict_from_jax, dict(depth=2)),
    "stcformer": (jstc.STCFormer, jstc.STCFormerConfig(n_layers=2, d_hid=32,
                                                       num_heads=4),
                  STCFormer, STCFormerConfig(n_layers=2, d_hid=32, num_heads=4),
                  stcformer_state_dict_from_jax, dict(n_layers=2)),
    "ktpformer": (jktp.KTPFormer, jktp.KTPFormerConfig(embed_dim=32, depth=2,
                                                       num_heads=4),
                  KTPFormer, KTPFormerConfig(embed_dim=32, depth=2, num_heads=4),
                  ktpformer_state_dict_from_jax, dict(depth=2)),
}
_CONVERTERS = {"mag": motionagformer_state_dict_to_params,
               "mixste": mixste_state_dict_to_params,
               "dstformer": dstformer_state_dict_to_params,
               "stcformer": stcformer_state_dict_to_params,
               "ktpformer": ktpformer_state_dict_to_params}
# full width: the configs' defaults, the published widths of each family
FULL = {
    "mag_base": (JaxMotionAGFormerConfig(), MotionAGFormerConfig()),
    "mag_tcn": (JaxMotionAGFormerConfig(use_tcn=True), MotionAGFormerConfig(use_tcn=True)),
    "mag_hierarchical": (JaxMotionAGFormerConfig(hierarchical=True),
                         MotionAGFormerConfig(hierarchical=True)),
    "mag_graph_only": (JaxMotionAGFormerConfig(graph_only=True),
                       MotionAGFormerConfig(graph_only=True)),
    "mixste": (JaxMixSTEConfig(), MixSTEConfig()),
    "dstformer": (JaxDSTFormerConfig(), DSTFormerConfig()),
    "stcformer": (jstc.STCFormerConfig(), STCFormerConfig()),
    # MixSTE's trunk, which KTPFormer keeps (the JAX config's default is 256)
    "ktpformer": (jktp.KTPFormerConfig(embed_dim=512), KTPFormerConfig(embed_dim=512)),
}
X = RNG.standard_normal((2, 27, 17, 3)).astype(np.float32)


def _family(name: str):
    jcls, jcfg, tcls, tcfg, carrier, _ = FAMILIES[name]
    jmodel = jcls(jcfg)
    # perturb_tree re-draws every leaf, so `init`'s shapes are enough (an
    # eager init takes seconds even at this width)
    params, state = jax.eval_shape(jmodel.init, jax.random.key(7))
    rng = np.random.default_rng(7)
    params = perturb_tree(params, rng)
    state = perturb_tree(state, rng)
    port = tcls(tcfg)
    port.load_state_dict(carrier(params, state), strict=True)
    return jmodel, params, state, port.eval()


@pytest.fixture(scope="module")
def models():
    """Each family built once, its JAX forward on X compiled once."""
    out = {}
    for name in FAMILIES:
        jmodel, params, state, port = _family(name)
        want = jax.jit(lambda p, s, x, m=jmodel: m.apply(p, s, x, train=False)[0])(
            params, state, jnp.asarray(X))
        out[name] = (jmodel, params, state, port, np.asarray(want))
    return out


def _layer(tree, i: int):
    return jax.tree.map(lambda a: a[i], tree)


def _layer0(tree):
    return _layer(tree, 0)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- modules


def test_attention_tokens_matches_jax(models):
    _, params, _, port, _ = models["mixste"]
    x = RNG.standard_normal((6, 17, 32)).astype(np.float32)
    want = JL.attention_tokens(params["ste0"]["attn"], jnp.asarray(x), 4)
    with torch.inference_mode():
        got = TL.attention_tokens(port.STEblocks[0].attn, _t(x), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_transformer_block_matches_jax(models):
    """The MixSTE block at its LayerNorm eps of 1e-6."""
    _, params, _, port, _ = models["mixste"]
    x = RNG.standard_normal((6, 27, 32)).astype(np.float32)
    want = JL.transformer_block(params["ste0"], jnp.asarray(x), 4, None, 1e-6)
    with torch.inference_mode():
        got = port.STEblocks[0](_t(x), 4, None, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_mlp_ln_residual_matches_jax(models, eps):
    _, params, _, port, _ = models["mixste"]
    block, p = port.TTEblocks[0], params["tte0"]
    x = RNG.standard_normal((5, 27, 32)).astype(np.float32)
    want = JL.mlp_ln_residual(p["norm2"], p["mlp"], jnp.asarray(x), eps)
    with torch.inference_mode():
        got = TL.mlp_ln_residual(block.norm2, block.mlp, _t(x), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with torch.inference_mode():  # the unfused MLP of the drop-path branch
        unfused = block.mlp(TL.layer_norm(block.norm2, _t(x), eps))
    want_mlp = JL.mlp(p["mlp"], JL.layer_norm(p["norm2"], jnp.asarray(x), eps))
    np.testing.assert_allclose(unfused.numpy(), np.asarray(want_mlp), **TOL)


def test_drop_path_branch_keeps_or_drops_whole_rows(models):
    """With a rate and a generator the MLP tail takes the unfused branch:
    each leading row gets x + MLP(LN(x)) / keep or x alone, drawn from the
    generator (the JAX package's bits differ, so the rows are checked)."""
    port = models["mixste"][3]
    block = port.TTEblocks[1]
    x = _t(RNG.standard_normal((64, 27, 32)).astype(np.float32))
    with torch.inference_mode():
        y = block.mlp(TL.layer_norm(block.norm2, x, 1e-6))
        got = TL.mlp_ln_residual(block.norm2, block.mlp, x, 1e-6, 0.25,
                                 torch.Generator().manual_seed(3))
        again = TL.mlp_ln_residual(block.norm2, block.mlp, x, 1e-6, 0.25,
                                   torch.Generator().manual_seed(3))
    kept = torch.isclose(got, x + y / 0.75, atol=1e-5).all(dim=(1, 2))
    dropped = torch.equal(got[~kept], x[~kept])
    assert torch.equal(got, again) and dropped and 0 < kept.sum() < 64


@pytest.mark.parametrize("name", ["mixste", "dstformer"])
def test_stochastic_depth_runs_in_training_with_a_generator(models, name):
    """In training mode with a generator the model drops residual rows (rates
    up to 0.5 here), and the same seed drops the same rows; without a
    generator, or in eval mode, it is the plain forward (neither model has
    batch statistics)."""
    port = copy.deepcopy(models[name][3])
    port.cfg = dataclasses.replace(port.cfg, drop_path_rate=0.5)
    x = _t(X)
    with torch.no_grad():
        plain = port(x)
        port.train()
        free = port(x)
        a, b = (port(x, generator=torch.Generator().manual_seed(1))
                for _ in range(2))
        port.eval()
        evaluated = port(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(free, plain) and torch.equal(evaluated, plain)
    assert torch.equal(a, b) and float((a - plain).abs().max()) > 1e-3


def test_grads_fn_threads_its_generator_into_stochastic_depth(models):
    """`make_grads_fn` hands a zoo model the train step's generator (MixSTE's
    default drop_path_rate 0.2): the same seed gives the same gradients, no
    generator those of the plain forward."""
    port = copy.deepcopy(models["mixste"][3])
    grads_fn = make_grads_fn(port, Config())
    y = _t(RNG.standard_normal((2, 27, 17, 3)).astype(np.float32))

    def grads(generator):
        port.zero_grad(set_to_none=True)
        grads_fn(_t(X), y, torch.ones(2), generator)
        return port.STEblocks[0].attn.qkv.weight.grad.clone()

    a, b = (grads(torch.Generator().manual_seed(2)) for _ in range(2))
    assert torch.equal(a, b) and not torch.allclose(a, grads(None))


def _tcn(models):
    _, params, state, port, _ = models["mag_tcn"]
    p = _layer0(params["layers"])["graph_temporal"]["mixer"]
    s = _layer0(state["layers"])["graph_temporal"]
    return p, s, port.layers[0].graph_temporal.mixer


def test_conv2d_matches_jax(models):
    """The dilation-2 temporal conv of the MS-TCN: padding and dilation."""
    p, _, tcn = _tcn(models)
    x = RNG.standard_normal((2, 8, 27, 17)).astype(np.float32)
    want = JL.conv2d(p["branches"][1]["tconv"], jnp.asarray(x), padding=(4, 0),
                     dilation=(2, 1))
    with torch.inference_mode():
        got = TL.conv2d(tcn.branches[1][3].conv, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_2d_matches_jax(models, train):
    """Eval with the running statistics; train with the batch statistics and
    the running statistics updated (unbiased variance, momentum 0.1)."""
    p, s, tcn = _tcn(models)
    bn = copy.deepcopy(tcn.branches[0][1])
    x = RNG.standard_normal((3, 8, 27, 17)).astype(np.float32)
    want, new = JL.batch_norm_2d(p["branches"][0]["bn1"], s["branches"][0]["bn1"],
                                 jnp.asarray(x), train)
    with torch.no_grad():
        got = TL.batch_norm(bn, _t(x), train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_multi_scale_tcn_matches_jax(models, train):
    p, s, tcn = _tcn(models)
    tcn = copy.deepcopy(tcn).train(train)
    x = RNG.standard_normal((2, 27, 17, 32)).astype(np.float32)
    want, new = JL.multi_scale_tcn(p, s, jnp.asarray(x), train)
    with torch.no_grad():
        got = tcn(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bns = [(br[1], ns["bn1"]) for br, ns in zip(tcn.branches, new["branches"])]
    bns += [(tcn.branches[0][3].bn, new["branches"][0]["bn2"]),
            (tcn.branches[1][3].bn, new["branches"][1]["bn2"]),
            (tcn.branches[2][4], new["branches"][2]["bn2"])]
    for bn, ns in bns:
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(ns["mean"]), **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(ns["var"]), **TOL)


def _ktp_prior(models, name: str):
    """A KTPFormer prior (JAX params and state, the port's module): `kpa` on
    the 17 joints, `tpa1` on the 27 frames."""
    _, params, state, port, _ = models["ktpformer"]
    attn = port.tpattention.attn
    mod = port.kpattention.attn.kpa if name == "kpa" else attn.tpa.gconv1
    return params[name], state[name], mod


@pytest.mark.parametrize("name", ["kpa", "tpa1"])
def test_learnable_graph_conv_matches_jax(models, name):
    """The symmetrised base-plus-learned adjacency, its diagonal and
    off-diagonal terms gated per node."""
    p, _, prior = _ktp_prior(models, name)
    n, c_in = prior.gconv.M.shape[0], prior.gconv.W.shape[1]
    base = prior.gconv.base_adj.numpy()
    x = RNG.standard_normal((6, n, c_in)).astype(np.float32)
    want = jktp._lgc(p["gconv"], jnp.asarray(x), base)
    with torch.inference_mode():
        got = prior.gconv(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["kpa", "tpa1"])
def test_ktp_prior_matches_jax(models, name, train):
    """Graph conv, batch norm over the channels and ReLU: eval with the
    running statistics; train with the batch statistics and the running
    statistics updated."""
    p, s, prior = _ktp_prior(models, name)
    prior = copy.deepcopy(prior).train(train)
    n, c_in = prior.gconv.M.shape[0], prior.gconv.W.shape[1]
    x = RNG.standard_normal((6, n, c_in)).astype(np.float32)
    want, new = jktp._prior(p, s, jnp.asarray(x), prior.gconv.base_adj.numpy(),
                            train)
    with torch.no_grad():
        got = prior(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(prior.bn.running_mean.numpy(),
                               np.asarray(new["bn"]["mean"]), **TOL)
    np.testing.assert_allclose(prior.bn.running_var.numpy(),
                               np.asarray(new["bn"]["var"]), **TOL)


def test_ktp_adjacencies_match_jax():
    port = KTPFormer(KTPFormerConfig(embed_dim=32, depth=1, num_heads=4))
    np.testing.assert_array_equal(port.kpattention.attn.kpa.gconv.base_adj.numpy(),
                                  jktp.adj_mx_from_skeleton(17))
    np.testing.assert_array_equal(
        port.tpattention.attn.tpa.gconv2.gconv.base_adj.numpy(),
        jktp.adj_mx_from_skeleton_temporal(27))


def test_stc_attention_matches_jax(models):
    """The interleaved qkv split, the half-width scale, the depthwise
    convolutions and the part embeddings at 1e-4 / 1e-9."""
    _, params, _, port, _ = models["stcformer"]
    x = RNG.standard_normal((2, 27, 17, 32)).astype(np.float32)
    want = jstc._stc_attention(_layer0(params["blocks"]), jnp.asarray(x), 4)
    with torch.inference_mode():
        got = port.stcformer.stc_block[0].stc_att(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bias_free_mlp_ln_residual_matches_jax(models):
    """STCFormer's MLP tail: no bias parameters in the module, zero biases
    handed to `fused_mlp_ln` (as the JAX `mlp_ln_residual` does), with and
    without autograd."""
    _, params, _, port, _ = models["stcformer"]
    block, p = port.stcformer.stc_block[1], _layer(params["blocks"], 1)
    assert block.mlp.fc1.bias is None and block.mlp.fc2.bias is None
    x = RNG.standard_normal((2, 27, 17, 32)).astype(np.float32)
    want = JL.mlp_ln_residual(p["mlp_norm"], p["mlp"], jnp.asarray(x))
    with torch.inference_mode():
        got = TL.mlp_ln_residual(block.layer_norm, block.mlp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with torch.enable_grad():
        got = TL.mlp_ln_residual(block.layer_norm, block.mlp, _t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------- models


@pytest.mark.parametrize("name", list(FAMILIES))
def test_small_model_matches_jax(models, name):
    """The whole model, `apply(train=False)` in JAX, eval in the port."""
    *_, port, want = models[name]
    with torch.inference_mode():
        got = port(_t(X)).numpy()
    assert got.shape == (2, 27, 17, 3)
    assert float(np.abs(got - want).max()) <= 1e-5


@pytest.mark.parametrize("name", list(FULL))
def test_full_width_parameter_count_matches_jax(name):
    """The configs' defaults (MixSTE 512 wide, depth 8; DSTFormer 256 wide,
    depth 5; MotionAGFormer 16 layers of 128; STCFormer 6 blocks of 256) and
    KTPFormer at 512, depth 8: shapes only, nothing runs."""
    jcls, tcls = FAMILIES[name][0], FAMILIES[name][2]
    jcfg, tcfg = FULL[name]
    jmodel = jcls(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))[0]
    with torch.device("meta"):
        port = tcls(tcfg)
    assert port.parameter_count() == jmodel.parameter_count(shapes)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_carrier_round_trips_through_the_jax_converter(name):
    """port state_dict -> JAX `*_state_dict_to_params` -> the port's carrier
    gives back the same state_dict, which loads strictly."""
    _, _, tcls, tcfg, carrier, kwargs = FAMILIES[name]
    port = tcls(tcfg)
    port.reset_parameters(torch.Generator().manual_seed(5))
    sd = port.state_dict()
    params, state = _CONVERTERS[name.split("_")[0]](sd, **kwargs)
    back = carrier(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key
    tcls(tcfg).load_state_dict(back, strict=True)


def test_zoo_registers_on_first_factory_miss():
    """In a fresh interpreter the factory knows the zoo as soon as the models
    package is imported: no zoo module is imported by the caller."""
    code = (
        "from kasportsformer_torch.config import Config\n"
        "from kasportsformer_torch.models import available_models, build_model\n"
        "assert available_models() == ['d3dp', 'dstformer', 'kasportsformer', "
        "'ktpformer', 'mixste', 'motionagformer', 'stcformer'], "
        "available_models()\n"
        "m = build_model(Config(model_name='MixSTE', n_layers=1, dim_feat=32, "
        "num_heads=4), device='cpu')\n"
        "print(type(m).__name__, available_models())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "MixSTE"


def test_lift_service_serves_a_zoo_model_on_cpu(models):
    """The serving path needs no code of its own for the zoo: the small
    MixSTE behind `LiftService` lifts a 40-frame track to root-zeroed poses."""
    port = models["mixste"][3]
    kpts = RNG.uniform(0, 1000, (40, 17, 2)).astype(np.float32)
    poses = LiftService(port, device="cpu").lift_sequence(kpts, 1280, 720)
    assert poses.shape == (40, 17, 3) and np.isfinite(poses).all()
    assert np.abs(poses[:, 0]).max() == 0.0
