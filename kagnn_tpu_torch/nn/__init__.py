from kagnn_tpu_torch.nn.convs import (GATConv, GCNConv, GINConv,  # noqa: F401
                                      GINEConv, dense_transform,
                                      fastkan_transform, global_add_pool,
                                      global_mean_pool, kan_transform)
from kagnn_tpu_torch.nn.encoders import (AtomEncoder,  # noqa: F401
                                         BondEncoder, CategoricalSumEncoder)
from kagnn_tpu_torch.nn.kagnn import (FASTKAGATConv,  # noqa: F401
                                      FASTKAGCNConv, GIFASTKANLayer,
                                      GIKANLayer, KAGATConv, KAGCNConv,
                                      KAGINEConv, make_fastkan, make_kan,
                                      make_mlp)
from kagnn_tpu_torch.nn.mlp import MLP, TorchLinear  # noqa: F401
