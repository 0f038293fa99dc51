"""DPUV4E on PyTorch / CUDA: the H100 port of the `repro` JAX package.

The layout mirrors `repro` (core/, configs/, kernels/, compiler/, models/,
serve/) so each module's counterpart is easy to find.  The package imports
`torch` and never `jax`, and it imports nothing of `repro`: what it needs
from there it keeps as its own copy.  The Pallas TPU kernels on the
static-int8 CNN serving path are hand-written CUDA C++ for sm_90a
(`csrc/*.cu`), built with nvcc at first use and bound with ctypes
(kernels/_build.py).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""
