"""Models of the port: the flagship KASportsFormer, the zoo and their layer
library. Importing the package registers every model with the factory."""

from kasportsformer_torch.models.registry import available_models, build_model
from kasportsformer_torch.models import zoo  # noqa: F401  (registers the zoo)

__all__ = ["available_models", "build_model"]
