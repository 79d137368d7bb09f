from kagnn_tpu_torch.models.graph import GraphClassifier  # noqa: F401
from kagnn_tpu_torch.models.node import NodeClassifier  # noqa: F401
from kagnn_tpu_torch.models.regression import GraphRegressor  # noqa: F401
