from kagnn_tpu_torch.nn.convs import (GATConv, GCNConv, GINConv,  # noqa: F401
                                      GINEConv, fastkan_transform,
                                      global_add_pool, global_mean_pool,
                                      kan_transform)
from kagnn_tpu_torch.nn.encoders import (AtomEncoder,  # noqa: F401
                                         BondEncoder, CategoricalSumEncoder)
