from kagnn_tpu_torch.nn.convs import (GCNConv, GINConv,  # noqa: F401
                                      fastkan_transform, kan_transform)
