"""Checkpoints: reference `.pth` loading, native training-state
checkpoints, and the weight carrier from the JAX package's `(params, state)`
pytrees (port of parts of `kasportsformer_tpu/train/checkpoint.py`).

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


def _layer(tree: dict[str, Any], i: int) -> dict[str, Any]:
    """Slice layer i out of a layer-stacked pytree of numpy arrays."""
    return {k: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def state_dict_from_jax(params: dict[str, Any], state: dict[str, Any]
                        ) -> dict[str, torch.Tensor]:
    """The JAX package's KASportsFormer `(params, state)`, as nested dicts of
    numpy arrays, -> the port's state_dict.

    Mirrors `params_to_torch_state_dict(params, state, module_prefix=False)`:
    linears go from (in, out) to (out, in), BoneRefusion's zero-padded dense
    stack is cut back to each combination's width, and the stacked layer axis
    becomes `layers_with_bone.{i}`."""
    out: dict[str, torch.Tensor] = {}

    def put(key: str, arr) -> None:
        out[key] = torch.from_numpy(np.array(arr))

    def put_lin(key: str, p: dict[str, Any]) -> None:
        put(f"{key}.weight", np.asarray(p["w"]).T)
        if "b" in p:
            put(f"{key}.bias", p["b"])

    def put_ln(key: str, p: dict[str, Any]) -> None:
        put(f"{key}.weight", p["scale"])
        put(f"{key}.bias", p["bias"])

    put_lin("joints_embed", params["joints_embed"])
    put_lin("bone_embed", params["bone_embed"])
    put_lin("limb_embed", params["limb_embed"])
    put("pos_embed", params["pos_embed"])
    put("bone_pos_embed", params["bone_pos_embed"])
    put("limb_pos_embed", params["limb_pos_embed"])
    put_ln("norm", params["norm"])
    put_lin("rep_logit.fc", params["rep_logit"])
    put_lin("head", params["head"])

    br = {k: np.asarray(v) for k, v in params["bone_refusion"].items()}
    for g, combo in enumerate(LIMB_COMBINATIONS):
        k = len(combo)
        for c, ch in enumerate(_BONE_CHANNELS):
            base = f"bone_refusion.mlp_layers.{g}.{ch}"
            put(f"{base}.fc1.weight", br["w1"][g, c, :k].T)
            put(f"{base}.fc1.bias", br["b1"][g, c])
            put(f"{base}.fc2.weight", br["w2"][g, c][None, :])
            put(f"{base}.fc2.bias", br["b2"][g, c][None])

    n_layers = int(np.asarray(params["layers"]["fusion"]["w"]).shape[0])
    for i in range(n_layers):
        lp = _layer(params["layers"], i)
        ls = _layer(state["layers"], i)
        for name in TRUNK_MODULES:
            prefix = f"layers_with_bone.{i}.{name}"
            p = lp[name]
            put_ln(f"{prefix}.norm1", p["norm1"])
            put_ln(f"{prefix}.norm1_limb", p["norm1_limb"])
            put_ln(f"{prefix}.norm2", p["norm2"])
            put_lin(f"{prefix}.mlp.fc1", p["mlp"]["fc1"])
            put_lin(f"{prefix}.mlp.fc2", p["mlp"]["fc2"])
            put(f"{prefix}.layer_scale_1", p["ls1"])
            put(f"{prefix}.layer_scale_2", p["ls2"])
            m = p["mixer"]
            if "qkv" in m:
                put_lin(f"{prefix}.mixer.qkv", m["qkv"])
                put_lin(f"{prefix}.mixer.proj", m["proj"])
            elif "q" in m:
                put_lin(f"{prefix}.mixer.qkv_q", m["q"])
                put_lin(f"{prefix}.mixer.qkv_kv", m["kv"])
                put_lin(f"{prefix}.mixer.proj", m["proj"])
            else:
                put_lin(f"{prefix}.mixer.U", m["U"])
                put_lin(f"{prefix}.mixer.V", m["V"])
                put(f"{prefix}.mixer.batch_norm.weight", m["bn"]["scale"])
                put(f"{prefix}.mixer.batch_norm.bias", m["bn"]["bias"])
                put(f"{prefix}.mixer.batch_norm.running_mean",
                    ls[name]["bn"]["mean"])
                put(f"{prefix}.mixer.batch_norm.running_var",
                    ls[name]["bn"]["var"])
                put(f"{prefix}.mixer.batch_norm.num_batches_tracked",
                    np.zeros((), np.int64))
        put_lin(f"layers_with_bone.{i}.fusion_three_channel", lp["fusion"])
    return out


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
