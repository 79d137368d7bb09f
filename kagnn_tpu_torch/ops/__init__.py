from kagnn_tpu_torch.ops.norm import MaskedBatchNorm  # noqa: F401
from kagnn_tpu_torch.ops.segment import (gather, neighbor_sum,  # noqa: F401
                                         segment_mean, segment_sum,
                                         sender_gather)
