from kagnn_tpu_torch.models.node import NodeClassifier  # noqa: F401
