"""kagnn_tpu_torch — the PyTorch/CUDA port of kagnn_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout (`data/`, `graphs/`, `kan/`,
`ops/`, `nn/`, `models/`, `train/`, `dist/`, `utils/`), so each module has
a counterpart of the same name in `kagnn_tpu`. The Pallas kernels of the JAX
package become hand-written CUDA C++ kernels for sm_90a: the sources live in
`csrc/`, the Python wrappers (autograd Functions, launch counters and the
plain PyTorch version of each kernel) in `kernels/`.

It imports torch only: no jax, flax, optax and nothing of `kagnn_tpu`.
Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on the CPU every kernel wrapper runs its plain version.
"""

__version__ = "0.1.0"
