"""convopeq_tpu_torch — the PyTorch and CUDA counterpart of `convopeq_tpu`.

The same module paths and function names as the JAX package, so each
counterpart is found at once.  This package imports `torch` and never
`jax`.  It holds the folded throughput chain (`models/chain.py`:
`prepare_folded_convolver` + `process_chain_fused`), whose run time is
one uniform overlap-save partitioned convolution per channel, carried on
an NVIDIA H100 by three hand-written CUDA kernels
(`ops/frame_conv_kernels.py`, source `csrc/frame_conv.cu`).

Device rule: every function that makes tensors takes an explicit
`device`; nothing picks one by itself.  A CPU tensor takes each kernel's
plain PyTorch version; a CUDA tensor takes the kernel or raises.
"""

__version__ = "0.1.0"
