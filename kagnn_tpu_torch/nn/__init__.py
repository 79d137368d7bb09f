from kagnn_tpu_torch.nn.convs import (GATConv, GCNConv, GINConv,  # noqa: F401
                                      fastkan_transform, kan_transform)
