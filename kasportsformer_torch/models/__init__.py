"""Models of the port: the flagship KASportsFormer and its layer library."""

from kasportsformer_torch.models.registry import available_models, build_model

__all__ = ["available_models", "build_model"]
