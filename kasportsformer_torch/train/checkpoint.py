"""Checkpoints: reference `.pth` loading, native training-state
checkpoints, and the weight carriers from the JAX package's `(params, state)`
pytrees of the flagship and the zoo (port of parts of
`kasportsformer_tpu/train/checkpoint.py`).

The port's modules use the reference state-dict names, so a reference
state_dict loads with `model.load_state_dict(sd, strict=True)`. A native
checkpoint is a directory `step_<N>` holding `model.pth` (the model's
state_dict in the reference layout, itself a loadable reference `.pth`) and
`optimizer.pth` (the optimizer's state_dict); the trainer writes the JAX
sidecar `meta.json` beside it.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from kasportsformer_torch.models.kasportsformer import TRUNK_MODULES
from kasportsformer_torch.skeleton import LIMB_COMBINATIONS

_BONE_CHANNELS = ("mlp_dir_x", "mlp_dir_y", "mlp_len")


def strip_module_prefix(state_dict: dict[str, Any]) -> dict[str, Any]:
    """Drop DataParallel's 'module.' key prefix when present."""
    if any(k.startswith("module.") for k in state_dict):
        return {k[len("module."):]: v for k, v in state_dict.items()}
    return dict(state_dict)


def load_torch_checkpoint(path: str) -> dict[str, Any]:
    """Load a reference `.pth` file: a bare state_dict or the reference's full
    payload `{'model': state_dict, 'epoch': ..., ...}`, with or without the
    'module.' prefix. Returns the state_dict. Loaded with
    `weights_only=True`, so a file cannot run code when it is unpickled."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model" in payload:
        payload = payload["model"]
    return strip_module_prefix(payload)


def _layer(tree: Any, i: int) -> Any:
    """Slice layer i out of a layer-stacked pytree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layer(v, i) for v in tree]
    return np.asarray(tree)[i]


def _n_layers(tree: Any) -> int:
    """The stacked layer count of a pytree: the leading axis of a leaf."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return int(np.asarray(tree).shape[0])


# Writers of one JAX sub-tree into `out` under the reference's names.


def _put(out: dict, key: str, arr) -> None:
    out[key] = torch.from_numpy(np.array(arr))


def _put_lin(out: dict, key: str, p: dict) -> None:
    """A linear: (in, out) -> torch's (out, in)."""
    _put(out, f"{key}.weight", np.asarray(p["w"]).T)
    if "b" in p:
        _put(out, f"{key}.bias", p["b"])


def _put_ln(out: dict, key: str, p: dict) -> None:
    _put(out, f"{key}.weight", p["scale"])
    _put(out, f"{key}.bias", p["bias"])


def _put_bn(out: dict, key: str, p: dict, s: dict) -> None:
    """A batch norm's affine parameters and running statistics (the JAX
    state carries no update count: it is written as 0)."""
    _put_ln(out, key, p)
    _put(out, f"{key}.running_mean", s["mean"])
    _put(out, f"{key}.running_var", s["var"])
    _put(out, f"{key}.num_batches_tracked", np.zeros((), np.int64))


def _put_conv(out: dict, key: str, p: dict) -> None:
    _put(out, f"{key}.weight", p["w"])  # OIHW in both
    if "b" in p:
        _put(out, f"{key}.bias", p["b"])


def _put_gcn(out: dict, key: str, p: dict, s: dict) -> None:
    _put_lin(out, f"{key}.U", p["U"])
    _put_lin(out, f"{key}.V", p["V"])
    _put_bn(out, f"{key}.batch_norm", p["bn"], s["bn"])


def _put_mstcn(out: dict, key: str, p: dict, s: dict) -> None:
    """MultiScaleTCN (`model/modules/tcn.py:25-86`): the dilated branches
    [conv, bn, relu, TemporalConv(conv, bn)], the max-pool branch [conv, bn,
    relu, maxpool, bn] and the 1x1 branch [conv, bn], by Sequential index."""
    bp, bs = p["branches"], s["branches"]
    for i in range(len(bp) - 2):
        _put_conv(out, f"{key}.branches.{i}.0", bp[i]["conv1"])
        _put_bn(out, f"{key}.branches.{i}.1", bp[i]["bn1"], bs[i]["bn1"])
        _put_conv(out, f"{key}.branches.{i}.3.conv", bp[i]["tconv"])
        _put_bn(out, f"{key}.branches.{i}.3.bn", bp[i]["bn2"], bs[i]["bn2"])
    i = len(bp) - 2
    _put_conv(out, f"{key}.branches.{i}.0", bp[i]["conv1"])
    _put_bn(out, f"{key}.branches.{i}.1", bp[i]["bn1"], bs[i]["bn1"])
    _put_bn(out, f"{key}.branches.{i}.4", bp[i]["bn2"], bs[i]["bn2"])
    _put_conv(out, f"{key}.branches.{i + 1}.0", bp[i + 1]["conv1"])
    _put_bn(out, f"{key}.branches.{i + 1}.1", bp[i + 1]["bn1"], bs[i + 1]["bn1"])


def _put_former(out: dict, key: str, p: dict, s: dict) -> None:
    """A FormerModule (KASportsFormer's, or MotionAGFormer's AGFormerBlock
    without `norm1_limb`); the mixer is told apart by its parameters."""
    _put_ln(out, f"{key}.norm1", p["norm1"])
    if "norm1_limb" in p:
        _put_ln(out, f"{key}.norm1_limb", p["norm1_limb"])
    _put_ln(out, f"{key}.norm2", p["norm2"])
    _put_lin(out, f"{key}.mlp.fc1", p["mlp"]["fc1"])
    _put_lin(out, f"{key}.mlp.fc2", p["mlp"]["fc2"])
    if "ls1" in p:
        _put(out, f"{key}.layer_scale_1", p["ls1"])
        _put(out, f"{key}.layer_scale_2", p["ls2"])
    m = p["mixer"]
    if "qkv" in m:
        _put_lin(out, f"{key}.mixer.qkv", m["qkv"])
        _put_lin(out, f"{key}.mixer.proj", m["proj"])
    elif "q" in m:
        _put_lin(out, f"{key}.mixer.qkv_q", m["q"])
        _put_lin(out, f"{key}.mixer.qkv_kv", m["kv"])
        _put_lin(out, f"{key}.mixer.proj", m["proj"])
    elif "branches" in m:
        _put_mstcn(out, f"{key}.mixer", m, s)
    else:
        _put_gcn(out, f"{key}.mixer", m, s)


def _put_tblock(out: dict, key: str, p: dict) -> None:
    """A MixSTE-style pre-LN transformer block (`model/MixSTE.py:299`)."""
    _put_ln(out, f"{key}.norm1", p["norm1"])
    _put_lin(out, f"{key}.attn.qkv", p["attn"]["qkv"])
    _put_lin(out, f"{key}.attn.proj", p["attn"]["proj"])
    _put_ln(out, f"{key}.norm2", p["norm2"])
    _put_lin(out, f"{key}.mlp.fc1", p["mlp"]["fc1"])
    _put_lin(out, f"{key}.mlp.fc2", p["mlp"]["fc2"])


def state_dict_from_jax(params: dict[str, Any], state: dict[str, Any]
                        ) -> dict[str, torch.Tensor]:
    """The JAX package's KASportsFormer `(params, state)`, as nested dicts of
    numpy arrays, -> the port's state_dict.

    Mirrors `params_to_torch_state_dict(params, state, module_prefix=False)`:
    linears go from (in, out) to (out, in), BoneRefusion's zero-padded dense
    stack is cut back to each combination's width, and the stacked layer axis
    becomes `layers_with_bone.{i}`."""
    out: dict[str, torch.Tensor] = {}
    _put_lin(out, "joints_embed", params["joints_embed"])
    _put_lin(out, "bone_embed", params["bone_embed"])
    _put_lin(out, "limb_embed", params["limb_embed"])
    _put(out, "pos_embed", params["pos_embed"])
    _put(out, "bone_pos_embed", params["bone_pos_embed"])
    _put(out, "limb_pos_embed", params["limb_pos_embed"])
    _put_ln(out, "norm", params["norm"])
    _put_lin(out, "rep_logit.fc", params["rep_logit"])
    _put_lin(out, "head", params["head"])

    br = {k: np.asarray(v) for k, v in params["bone_refusion"].items()}
    for g, combo in enumerate(LIMB_COMBINATIONS):
        k = len(combo)
        for c, ch in enumerate(_BONE_CHANNELS):
            base = f"bone_refusion.mlp_layers.{g}.{ch}"
            _put(out, f"{base}.fc1.weight", br["w1"][g, c, :k].T)
            _put(out, f"{base}.fc1.bias", br["b1"][g, c])
            _put(out, f"{base}.fc2.weight", br["w2"][g, c][None, :])
            _put(out, f"{base}.fc2.bias", br["b2"][g, c][None])

    for i in range(_n_layers(params["layers"]["fusion"])):
        lp = _layer(params["layers"], i)
        ls = _layer(state["layers"], i)
        for name in TRUNK_MODULES:
            _put_former(out, f"layers_with_bone.{i}.{name}", lp[name],
                        ls.get(name, {}))
        _put_lin(out, f"layers_with_bone.{i}.fusion_three_channel", lp["fusion"])
    return out


def motionagformer_state_dict_from_jax(params: dict[str, Any],
                                       state: dict[str, Any]
                                       ) -> dict[str, torch.Tensor]:
    """The JAX zoo MotionAGFormer's `(params, state)` (numpy) -> the port's
    state_dict in the reference layout: the inverse of the JAX package's
    `motionagformer_state_dict_to_params`. The variant (graph_only, use_tcn,
    hierarchical, fusion) is read off the pytree."""
    out: dict[str, torch.Tensor] = {}
    _put_lin(out, "joints_embed", params["joints_embed"])
    _put(out, "pos_embed", params["pos_embed"])
    _put_ln(out, "norm", params["norm"])
    _put_lin(out, "rep_logit.fc", params["rep_logit"])
    _put_lin(out, "head", params["head"])
    for i in range(_n_layers(params["layers"]["att_spatial"])):
        lp = _layer(params["layers"], i)
        ls = _layer(state["layers"], i)
        for name in ("att_spatial", "att_temporal", "graph_spatial",
                     "graph_temporal"):
            key, p, s = f"layers.{i}.{name}", lp[name], ls.get(name, {})
            if "norm1" in p:
                _put_former(out, key, p, s)
            elif "branches" in p:  # graph_only with use_tcn
                _put_mstcn(out, key, p, s)
            else:  # graph_only
                _put_gcn(out, key, p, s)
        if "fusion" in lp:
            _put_lin(out, f"layers.{i}.fusion", lp["fusion"])
    return out


def mixste_state_dict_from_jax(params: dict[str, Any], state: dict[str, Any]
                               ) -> dict[str, torch.Tensor]:
    """The JAX zoo MixSTE's `(params, state)` (numpy) -> the port's
    state_dict in the reference MixSTE2 layout: the inverse of the JAX
    package's `mixste_state_dict_to_params`."""
    del state  # MixSTE has none
    out: dict[str, torch.Tensor] = {}
    _put_lin(out, "Spatial_patch_to_embedding", params["spatial_embed"])
    _put(out, "Spatial_pos_embed", params["spatial_pos_embed"])
    _put(out, "Temporal_pos_embed", params["temporal_pos_embed"])
    _put_ln(out, "Spatial_norm", params["spatial_norm"])
    _put_ln(out, "Temporal_norm", params["temporal_norm"])
    _put_ln(out, "head.0", params["head_norm"])
    _put_lin(out, "head.1", params["head"])
    for stream, name in (("ste", "STEblocks"), ("tte", "TTEblocks")):
        _put_tblock(out, f"{name}.0", params[f"{stream}0"])
        rest = params.get(f"{stream}_rest")
        for i in range(_n_layers(rest) if rest is not None else 0):
            _put_tblock(out, f"{name}.{i + 1}", _layer(rest, i))
    return out


def dstformer_state_dict_from_jax(params: dict[str, Any], state: dict[str, Any]
                                  ) -> dict[str, torch.Tensor]:
    """The JAX zoo DSTFormer's `(params, state)` (numpy) -> the port's
    state_dict in the reference DSTformer layout: the inverse of the JAX
    package's `dstformer_state_dict_to_params`."""
    del state  # DSTFormer has none
    out: dict[str, torch.Tensor] = {}
    _put_lin(out, "joints_embed", params["joints_embed"])
    _put(out, "pos_embed", params["pos_embed"])
    _put(out, "temp_embed", params["temp_embed"])
    _put_ln(out, "norm", params["norm"])
    _put_lin(out, "pre_logits.fc", params["pre_logits"])
    _put_lin(out, "head", params["head"])
    for stream in ("blocks_st", "blocks_ts"):
        for i in range(_n_layers(params[stream])):
            p = _layer(params[stream], i)
            for part in ("norm1_s", "norm1_t", "norm2_s", "norm2_t"):
                _put_ln(out, f"{stream}.{i}.{part}", p[part])
            for s in ("s", "t"):
                _put_lin(out, f"{stream}.{i}.attn_{s}.qkv", p[f"attn_{s}"]["qkv"])
                _put_lin(out, f"{stream}.{i}.attn_{s}.proj", p[f"attn_{s}"]["proj"])
                _put_lin(out, f"{stream}.{i}.mlp_{s}.fc1", p[f"mlp_{s}"]["fc1"])
                _put_lin(out, f"{stream}.{i}.mlp_{s}.fc2", p[f"mlp_{s}"]["fc2"])
    if "ts_attn" in params:
        w, b = (np.asarray(params["ts_attn"][k]) for k in ("w", "b"))
        for i in range(w.shape[0]):
            _put_lin(out, f"ts_attn.{i}", {"w": w[i], "b": b[i]})
    return out


def stcformer_state_dict_from_jax(params: dict[str, Any], state: dict[str, Any]
                                  ) -> dict[str, torch.Tensor]:
    """The JAX zoo STCFormer's `(params, state)` (numpy) -> the port's
    state_dict in the reference layout: the inverse of the JAX package's
    `stcformer_state_dict_to_params`."""
    del state  # STCFormer has none
    out: dict[str, torch.Tensor] = {}
    _put_lin(out, "pose_emb", params["pose_emb"])
    _put_lin(out, "regress_head", params["head"])
    for i in range(_n_layers(params["blocks"])):
        p = _layer(params["blocks"], i)
        key = f"stcformer.stc_block.{i}"
        _put_ln(out, f"{key}.stc_att.layer_norm", p["norm"])
        _put_lin(out, f"{key}.stc_att.qkv", p["qkv"])
        _put_lin(out, f"{key}.stc_att.proj", p["proj"])
        _put_conv(out, f"{key}.stc_att.sep2_s", p["sep2_s"])
        _put_conv(out, f"{key}.stc_att.sep2_t", p["sep2_t"])
        _put(out, f"{key}.stc_att.emb.weight", p["part_embed"])
        _put_ln(out, f"{key}.layer_norm", p["mlp_norm"])
        _put_lin(out, f"{key}.mlp.fc1", p["mlp"]["fc1"])
        _put_lin(out, f"{key}.mlp.fc2", p["mlp"]["fc2"])
    return out


def ktpformer_state_dict_from_jax(params: dict[str, Any], state: dict[str, Any]
                                  ) -> dict[str, torch.Tensor]:
    """The JAX zoo KTPFormer's `(params, state)` (numpy) -> the port's
    state_dict in the reference layout, the prior batch norms' running
    statistics from `state`: the inverse of the JAX package's
    `ktpformer_state_dict_to_params`."""
    out: dict[str, torch.Tensor] = {}
    for key, name in (("kpattention.attn.kpa", "kpa"),
                      ("tpattention.attn.tpa.gconv1", "tpa1"),
                      ("tpattention.attn.tpa.gconv2", "tpa2")):
        g = params[name]["gconv"]
        for part in ("W", "M", "adj2"):
            _put(out, f"{key}.gconv.{part}", g[part])
        _put(out, f"{key}.gconv.bias", g["b"])
        _put_bn(out, f"{key}.bn", params[name]["bn"], state[name]["bn"])
    for key, name, pos in (("kpattention", "kpa", "Spatial_pos_embed"),
                           ("tpattention", "tpa", "Temporal_pos_embed")):
        _put(out, f"{key}.attn.{pos}", params[f"{name}_pos_embed"])
        _put_ln(out, f"{key}.attn.norm1", params[f"{name}_norm1"])
        _put_lin(out, f"{key}.attn.qkv", params[f"{name}_attn"]["qkv"])
        _put_lin(out, f"{key}.attn.proj", params[f"{name}_attn"]["proj"])
        _put_ln(out, f"{key}.norm2", params[f"{name}_mlp_norm"])
        _put_lin(out, f"{key}.mlp.fc1", params[f"{name}_mlp"]["fc1"])
        _put_lin(out, f"{key}.mlp.fc2", params[f"{name}_mlp"]["fc2"])
    _put_ln(out, "Spatial_norm", params["spatial_norm"])
    _put_ln(out, "Temporal_norm", params["temporal_norm"])
    _put_ln(out, "head.0", params["head_norm"])
    _put_lin(out, "head.1", params["head"])
    for stream, name in (("ste", "STEblocks"), ("tte", "TTEblocks")):
        for i in range(_n_layers(params[stream])):
            _put_tblock(out, f"{name}.{i}", _layer(params[stream], i))
    return out


def d3dp_state_dict_from_jax(params: dict[str, Any], state: dict[str, Any]
                             ) -> dict[str, torch.Tensor]:
    """The JAX zoo D3DP's denoiser `(params, state)` (numpy) -> the port's
    state_dict in the reference layout, under `pose_estimator.`: the inverse
    of the JAX package's `d3dp_state_dict_to_params`. The denoiser is MixSTE
    with a time MLP (`time_mlp.1`, `time_mlp.3`); the diffusion schedule is
    no parameter: both sides recompute it from `timesteps`."""
    out = mixste_state_dict_from_jax(params, state)
    _put_lin(out, "time_mlp.1", params["time_mlp"]["fc1"])
    _put_lin(out, "time_mlp.3", params["time_mlp"]["fc2"])
    return {f"pose_estimator.{k}": v for k, v in out.items()}


# ------------------------------------------------------------ native


def save_native(directory: str, step: int, payload: dict[str, Any]) -> None:
    """Save {'model': state_dict, 'optimizer': state_dict} under
    `directory/step_<step>`, each file written whole or not at all."""
    out = os.path.join(os.path.abspath(directory), f"step_{step}")
    os.makedirs(out, exist_ok=True)
    for name, value in payload.items():
        path = os.path.join(out, f"{name}.pth")
        torch.save(value, path + ".tmp")
        os.replace(path + ".tmp", path)


def restore_native(directory: str, step: int | None = None) -> dict[str, Any]:
    """Load a native checkpoint: `directory` is the parent (then `step`, or
    the latest step when None) or a `step_<N>` directory itself. Returns
    {'model': ..., 'optimizer': ...} (whichever were saved), loaded on the
    CPU with `weights_only=True`."""
    directory = os.path.abspath(directory)
    if not os.path.basename(directory).startswith("step_"):
        if step is None:
            step = latest_native_step(directory)
            if step is None:
                raise FileNotFoundError(f"no step_* checkpoints under {directory}")
        directory = os.path.join(directory, f"step_{step}")
    return {name[:-len(".pth")]: torch.load(os.path.join(directory, name),
                                            map_location="cpu",
                                            weights_only=True)
            for name in sorted(os.listdir(directory)) if name.endswith(".pth")}


def latest_native_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None
