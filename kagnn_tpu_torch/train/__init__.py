from kagnn_tpu_torch.train.loops import (EarlyStopper,  # noqa: F401
                                        make_graph_cls_steps,
                                        make_graph_reg_steps,
                                        make_node_multi_step,
                                        make_node_steps, train_graph_epochs)
from kagnn_tpu_torch.train.losses import (masked_accuracy,  # noqa: F401
                                          masked_l1, masked_nll,
                                          masked_softmax_cross_entropy)
