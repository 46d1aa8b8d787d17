from tcct_tpu_torch.ops.pool import (
    avg_pool_2d,
    max_pool_2d,
    metapool_tokens_backward_reference,
    metapool_spatial,
    metapool_tokens_reference,
)
from tcct_tpu_torch.ops.resize import resize_bicubic, resize_bilinear, resize_nearest
