"""kasportsformer_torch's layers and flagship model against the JAX package,
on the CPU in float32, with the same numpy-drawn weights loaded into both:
per module at a small size, the whole small model, and one full-width
26-layer forward. Also the weight carrier, config loading, the registry,
and the package's independence from JAX."""

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

from kasportsformer_tpu.config import load_config as jax_load_config
from kasportsformer_tpu.models import layers as JL
from kasportsformer_tpu.models.kasportsformer import (
    bone_decomposer as jax_bone_decomposer,
    bone_refusion as jax_bone_refusion,
)
from kasportsformer_tpu.train.checkpoint import params_to_torch_state_dict
from kasportsformer_torch.config import Config, load_config
from kasportsformer_torch.demo.lifting import resample_indices
from kasportsformer_torch.models import build_model
from kasportsformer_torch.models import layers as TL
from kasportsformer_torch.models.kasportsformer import bone_decomposer
from kasportsformer_torch.train.checkpoint import (
    load_torch_checkpoint,
    state_dict_from_jax,
)
from torch_parity import (
    SMALL,
    jax_flagship,
    jax_forward,
    torch_flagship,
    torch_forward,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(23)
# small shapes gain nothing from intra-op threads: leave the cores to the
# suite's other workers
torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def small():
    model, params, state = jax_flagship(3, **SMALL)
    return model, params, state, torch_flagship(params, state, **SMALL)


@pytest.fixture(scope="module")
def full():
    model, params, state = jax_flagship(4)
    return model, params, state, torch_flagship(params, state)


def _stream(c: int = 32, b: int = 2) -> np.ndarray:
    return RNG.standard_normal((b, 27, 17, c)).astype(np.float32)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_gcn_matches_jax(small, mode):
    model, params, state, port = small
    name = f"graph_{mode}"
    p = _layer0(params["layers"])[name]["mixer"]
    s = _layer0(state["layers"])[name]
    x = _stream()
    want, _ = JL.gcn(p, s, jnp.asarray(x), mode, False,
                     spatial_norm_adj=model.spatial_norm_adj, neighbour_num=4)
    with torch.inference_mode():
        got = getattr(port.layers_with_bone[0], name).mixer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_temporal_adjacency_matches_jax():
    """The dynamic top-k adjacency alone: a threshold, so compare it first
    when a model deviation sits on one joint's frames."""
    tokens = RNG.standard_normal((6, 27, 32)).astype(np.float32)
    sim = jnp.einsum("ntc,nsc->nts", tokens, tokens)
    s = sim
    for _ in range(3):
        s = jnp.where(s >= s.max(-1, keepdims=True), -jnp.inf, s)
    want = (sim >= s.max(-1, keepdims=True)).astype(jnp.float32)
    got = TL.topk_adjacency(torch.from_numpy(tokens), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        TL.normalize_adjacency(got).numpy(),
        np.asarray(JL.normalize_adjacency(want)), **TOL)


def test_batch_norm_nodes_eval_matches_jax(small):
    _, params, state, port = small
    p = _layer0(params["layers"])["graph_temporal"]["mixer"]["bn"]
    s = _layer0(state["layers"])["graph_temporal"]["bn"]
    x = RNG.standard_normal((6, 27, 32)).astype(np.float32)
    want, _ = JL.batch_norm_nodes(p, s, jnp.asarray(x), False)
    bn = port.layers_with_bone[0].graph_temporal.mixer.batch_norm
    with torch.inference_mode():
        got = TL.batch_norm(bn, torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batch_norm_nodes_train_matches_jax():
    """Batch statistics, and running stats updated with the unbiased
    variance at momentum 0.1 (in place, in the port)."""
    bn = torch.nn.BatchNorm1d(17)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.running_var.uniform_(0.5, 1.5)
    p = {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy()}
    s = {"mean": bn.running_mean.numpy().copy(),
         "var": bn.running_var.numpy().copy()}
    x = RNG.standard_normal((6, 17, 32)).astype(np.float32)
    want, new_s = JL.batch_norm_nodes(p, s, jnp.asarray(x), True)
    with torch.no_grad():
        got = TL.batch_norm(bn, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), new_s["mean"], **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), new_s["var"], **TOL)


@pytest.mark.parametrize("name", ["att_spatial", "att_temporal",
                                  "graph_spatial", "graph_temporal",
                                  "bone_spatial", "bone_temporal"])
def test_former_module_matches_jax(small, name):
    model, params, state, port = small
    mixer = {"att": "attention", "graph": "graph", "bone": "bone"}[
        name.split("_")[0]]
    mode = name.split("_")[1]
    x, limb = _stream(), _stream()
    want, _ = JL.former_module(
        _layer0(params["layers"])[name], _layer0(state["layers"]).get(name, {}),
        jnp.asarray(x), mixer, mode, 4, False, x_limb=jnp.asarray(limb),
        spatial_norm_adj=model.spatial_norm_adj, neighbour_num=4)
    block = getattr(port.layers_with_bone[0], name)
    with torch.inference_mode():
        got = block(torch.from_numpy(x), torch.from_numpy(limb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bone_decomposer_matches_jax():
    x = RNG.standard_normal((2, 27, 17, 3)).astype(np.float32)
    x[0, 3] = 0.0  # an all-zero pose: every bone has length 0
    got = bone_decomposer(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jax_bone_decomposer(x)), **TOL)


def test_bone_refusion_matches_jax(small):
    _, params, _, port = small
    x = RNG.standard_normal((2, 27, 17, 3)).astype(np.float32)
    want = jax_bone_refusion(params["bone_refusion"], jnp.asarray(x))
    with torch.inference_mode():
        got = port.bone_refusion(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_small_model_matches_jax(small):
    model, params, state, port = small
    x = RNG.standard_normal((3, 27, 17, 3)).astype(np.float32)
    want = jax_forward(model, params, state, x)
    got = torch_forward(port, x)
    assert got.shape == (3, 27, 17, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_weight_casts_are_kept_until_the_weight_changes(small):
    """Outside autograd a bfloat16 forward converts each float32 weight once
    (`layers.cast`) and drops the kept copy when the weight changes in place;
    its output equals that of a forward that converts on every call."""
    port = copy.deepcopy(small[3])
    port.compute_dtype = torch.bfloat16
    x = torch.from_numpy(
        RNG.standard_normal((2, 27, 17, 3)).astype(np.float32))
    w = port.layers_with_bone[0].att_spatial.mlp.fc1.weight

    def forward(grad: bool) -> torch.Tensor:
        if grad:  # autograd on: every call converts afresh
            return port(x).detach()
        with torch.inference_mode():
            return port(x)

    first = forward(grad=False)
    with torch.no_grad():
        kept = TL.cast(w, torch.bfloat16)
        assert TL.cast(w, torch.bfloat16) is kept
    assert torch.equal(first, forward(grad=True))
    with torch.no_grad():
        w.mul_(1.5)
        assert TL.cast(w, torch.bfloat16) is not kept
        assert torch.equal(TL.cast(w, torch.bfloat16), w.bfloat16())
    changed = forward(grad=False)
    assert not torch.equal(changed, first)
    assert torch.equal(changed, forward(grad=True))


def test_repeated_frames_match_eager_jax():
    """A stretched tail clip repeats frames, which makes exact ties in the
    temporal GCN's top-k. The port keeps those ties exact, as an op-by-op
    JAX forward does; a jitted JAX forward need not, so the serving parity
    test compares whole clips. One layer: the op-by-op forward is slow."""
    cfg = dict(SMALL, n_layers=1)
    model, params, state = jax_flagship(8, **cfg)
    port = torch_flagship(params, state, **cfg)
    x = RNG.uniform(-1, 1, (2, 6, 17, 3)).astype(np.float32)
    x = x[:, resample_indices(6, 27)]  # 6 frames stretched to 27
    with jax.disable_jit():
        want = np.asarray(model.apply(params, state, jnp.asarray(x))[0])
    np.testing.assert_allclose(torch_forward(port, x), want, **TOL)


def test_full_width_model_matches_jax(full):
    """All 26 layers at the published widths, f32, B=2."""
    model, params, state, port = full
    x = RNG.standard_normal((2, 27, 17, 3)).astype(np.float32)
    want = jax_forward(model, params, state, x)
    got = torch_forward(port, x)
    dev = float(np.abs(got - want).max())
    print(f"full-width 26-layer f32 max abs deviation: {dev:.3e}")
    assert dev <= 1e-4


def test_state_dict_from_jax_matches_reference_layout(full):
    _, params, state, port = full
    want = params_to_torch_state_dict(params, state, module_prefix=False)
    got = state_dict_from_jax(params, state)
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    assert set(got) == set(port.state_dict())
    assert port.parameter_count() == 29_365_668


def test_load_torch_checkpoint_accepts_reference_payloads(small, tmp_path):
    """A `{'model': ...}` payload with DataParallel's 'module.' prefix, as the
    reference saves it, loads strictly into the port."""
    _, _, _, port = small
    sd = {f"module.{k}": v for k, v in port.state_dict().items()}
    path = tmp_path / "ckpt.pth"
    torch.save({"epoch": 3, "model": sd, "min_mpjpe": 41.5}, path)
    loaded = load_torch_checkpoint(str(path))
    assert set(loaded) == set(port.state_dict())
    fresh = torch_flagship(*jax_flagship(5, **SMALL)[1:], **SMALL)
    fresh.load_state_dict(loaded, strict=True)
    x = RNG.standard_normal((1, 27, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(torch_forward(fresh, x),
                                  torch_forward(port, x))


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(REPO, "configs"))))
def test_reference_configs_load_unchanged(name):
    path = os.path.join(REPO, "configs", name)
    got = dataclasses.asdict(load_config(path))
    want = dataclasses.asdict(jax_load_config(path))
    assert got == want


def test_build_model_defaults_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    cfg = Config(n_layers=1, dim_feat=32, num_heads=4, dim_rep=64)
    if torch.cuda.is_available():
        assert next(build_model(cfg).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert not model.training
    # the zoo registers with the package's import, so the error lists it too
    with pytest.raises(ValueError, match="available: \\['d3dp', 'dstformer', "
                       "'kasportsformer', 'ktpformer', 'mixste', "
                       "'motionagformer', 'stcformer'\\]"):
        build_model(cfg.replace(model_name="NoSuchModel"), device="cpu")


def test_build_model_is_seeded():
    cfg = Config(n_layers=1, dim_feat=32, num_heads=4, dim_rep=64)
    a, b = (build_model(cfg, device="cpu").state_dict() for _ in range(2))
    c = build_model(cfg.replace(seed=1), device="cpu").state_dict()
    key = "layers_with_bone.0.att_spatial.mixer.qkv.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kasportsformer_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kasportsformer_tpu')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith(pkg.__name__)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 21
    assert {f"kasportsformer_torch.{m}" for m in (
        "cli", "data.clips", "data.pipeline", "train.losses", "train.metrics",
        "train.loop", "train.evaluator", "train.checkpoint")} <= loaded
