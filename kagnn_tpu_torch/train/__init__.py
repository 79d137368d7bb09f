from kagnn_tpu_torch.train.loops import EarlyStopper, make_node_steps  # noqa: F401
from kagnn_tpu_torch.train.losses import (masked_accuracy,  # noqa: F401
                                          masked_softmax_cross_entropy)
