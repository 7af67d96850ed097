"""Model zoo of the port (≙ `kasportsformer_tpu/models/zoo`). Importing this
package registers its models with the factory: MotionAGFormer, MixSTE,
DSTFormer, STCFormer, KTPFormer and D3DP so far."""

from kasportsformer_torch.models.zoo import (  # noqa: F401
    d3dp,
    dstformer,
    ktpformer,
    mixste,
    motionagformer,
    stcformer,
)
