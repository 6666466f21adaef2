"""stylex_tpu_torch: StylEx in PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (H100).

A port of the JAX package ``stylex_tpu``, which stays in the repository as
the reference the port is tested against. This package imports neither JAX
nor ``stylex_tpu``. Tensors are NCHW and conv weights OIHW inside it; state
dicts use the reference checkpoint's keys; the public AttFind entry points
take and return the JAX package's layouts (NHWC numpy images and records).
"""

from stylex_tpu_torch.version import __version__

__all__ = ["__version__"]
