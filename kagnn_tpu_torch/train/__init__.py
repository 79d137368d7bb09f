from kagnn_tpu_torch.train.loops import (EarlyStopper,  # noqa: F401
                                        make_node_multi_step,
                                        make_node_steps)
from kagnn_tpu_torch.train.losses import (masked_accuracy,  # noqa: F401
                                          masked_softmax_cross_entropy)
