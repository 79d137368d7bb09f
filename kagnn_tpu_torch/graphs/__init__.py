from kagnn_tpu_torch.graphs.batch import GraphBatch, single_graph  # noqa: F401
