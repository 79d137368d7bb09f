from kagnn_tpu_torch.data.registry import (DATASET_LAYERS,  # noqa: F401
                                           GRAPH_DATASETS, NODE_DATASETS,
                                           load_graph_dataset,
                                           load_node_dataset,
                                           load_regression_dataset)
from kagnn_tpu_torch.data.splits import fold_indices, load_splits  # noqa: F401
from kagnn_tpu_torch.data.synthetic import (arxiv_scale_graph,  # noqa: F401
                                            community_node_graph,
                                            random_molecule_graphs)
