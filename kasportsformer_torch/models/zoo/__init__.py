"""Model zoo of the port (≙ `kasportsformer_tpu/models/zoo`). Importing this
package registers its models with the factory: MotionAGFormer, MixSTE and
DSTFormer so far."""

from kasportsformer_torch.models.zoo import (  # noqa: F401
    dstformer,
    mixste,
    motionagformer,
)
