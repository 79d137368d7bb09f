from kagnn_tpu_torch.data.synthetic import (arxiv_scale_graph,  # noqa: F401
                                            community_node_graph,
                                            random_molecule_graphs)
