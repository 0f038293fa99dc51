"""DPUV4E engine kernels for the H100.

  ref.py          plain PyTorch reference ops (the "ref" backend)
  _epilogue.py    the fused-epilogue chain's value semantics
  conv_pe.py      Conv PE int8 GEMM (+ residual / pooled variants)  [CUDA]
  dwc_pe.py       DWC PE depthwise conv                            [CUDA]
  low_channel.py  Low-Channel first-layer conv                     [CUDA]
  ops.py          public wrappers: backend dispatch, im2col, padding
  _build.py       nvcc build, ctypes binding, launch counts

Kernel modules build their CUDA sources at first use, never at import.
"""
