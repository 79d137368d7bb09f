from kagnn_tpu_torch.graphs.batch import (GraphBatch, PadSpec,  # noqa: F401
                                          batch_graphs, pad_spec_for,
                                          single_graph)
