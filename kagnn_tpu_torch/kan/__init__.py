from kagnn_tpu_torch.kan.layers import (KAN, FastKAN, FastKANLayer,  # noqa: F401
                                     KANLinear)
