"""Hand-written Hopper kernels of the port, one module per TPU kernel module
of `kagnn_tpu/pallas/`, each with its plain PyTorch version and a launch
counter. Sources: `kagnn_tpu_torch/csrc/`; build: `_build.py`."""
