"""Model factory (port of `kasportsformer_tpu/models/registry.py`, ≙
`model/model_tools.py:79-96`). KASportsFormer registers here, the zoo
(`models/zoo`) on its import, which `kasportsformer_torch.models` makes."""

from __future__ import annotations

from typing import Callable

import torch

from kasportsformer_torch.utils.common import resolve_device

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn
    return deco


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def build_model(config, device: str | torch.device = "cuda",
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """Build a model from a `kasportsformer_torch.config.Config` (or any
    object with its model fields), draw its weights from `generator` (default:
    one seeded with `config.seed`) and return it in eval mode on `device`.
    Raises on unknown names like `model/model_tools.py:93-94`, and on a CUDA
    device when CUDA is absent: pass device='cpu' to run on the CPU."""
    dev = resolve_device(device)
    name = config.model_name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"unrecognized model name {config.model_name!r}; "
                         f"available: {available_models()}")
    model = _REGISTRY[name](config)
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    model.reset_parameters(generator)
    return model.to(dev).eval()


@register_model("KASportsFormer")
def _build_kasportsformer(config):
    from kasportsformer_torch.models.kasportsformer import (
        KASportsFormer,
        KASportsFormerConfig,
    )

    cfg = KASportsFormerConfig(
        n_layers=config.n_layers,
        dim_in=config.dim_in,
        dim_feat=config.dim_feat,
        dim_rep=config.dim_rep,
        dim_out=config.dim_out,
        mlp_ratio=float(config.mlp_ratio),
        num_heads=config.num_heads,
        qkv_bias=config.qkv_bias,
        qkv_scale=config.qkv_scale,
        num_joints=config.num_joints,
        n_frames=config.n_frames,
        use_layer_scale=config.use_layer_scale,
        layer_scale_init_value=config.layer_scale_init_value,
        use_adaptive_fusion=config.use_adaptive_fusion,
        use_temporal_similarity=config.use_temporal_similarity,
        neighbour_num=config.neighbour_num,
        temporal_connection_len=config.temporal_connection_len,
    )
    dtype = (torch.bfloat16 if config.compute_dtype == "bfloat16"
             else torch.float32)
    return KASportsFormer(cfg, compute_dtype=dtype)
