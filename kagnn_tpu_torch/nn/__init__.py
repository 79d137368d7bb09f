from kagnn_tpu_torch.nn.convs import GINConv  # noqa: F401
