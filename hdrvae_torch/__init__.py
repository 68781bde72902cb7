"""hdrvae_torch: the HDR VAE decode on PyTorch and CUDA (NVIDIA Hopper).

The counterpart of the JAX package ``hdrvae`` module for module: the same
relative paths, names and NHWC layout at every public function, so a test
can hand the same numpy inputs to both.  The decoder's mid and up stack run
through hand-written CUDA kernels (``hdrvae_torch/csrc``) on a CUDA device;
on CPU tensors each kernel wrapper runs its plain PyTorch version instead.

Nothing here imports JAX.  Importing the package loads no library and
builds nothing: the kernels are compiled at their first launch
(``hdrvae_torch.kernels._build``).
"""

__version__ = "0.1.0"
