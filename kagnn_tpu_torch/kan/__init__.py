from kagnn_tpu_torch.kan.layers import KAN, KANLinear  # noqa: F401
