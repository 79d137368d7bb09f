from kagnn_tpu_torch.kan.layers import (KAN,  # noqa: F401
                                        AttentionWithFastKANTransform,
                                        FastKAN, FastKANLayer, KANLinear)
