"""convopeq_tpu_torch — the PyTorch and CUDA counterpart of `convopeq_tpu`.

The same module paths and function names as the JAX package, so each
counterpart is found at once.  This package imports `torch` and never
`jax`.  It holds the folded throughput chain (`models/chain.py`:
`prepare_folded_convolver` + `process_chain_fused`, `headline.py`), the
semi-folded render chain with dither (`config6.py`), and the reference
3-layer convolver with the fused-prefilter chain (`models/nuc.py`,
`models/convolver.py`, `nuc3.py`).  Their overlap-save partitioned
convolutions run on an NVIDIA H100 through hand-written CUDA kernels:
three frame kernels (`ops/frame_conv_kernels.py`) and the fused kernel
for layers of <= 8 partitions (`ops/fused_conv_kernels.py`), both from
`csrc/frame_conv.cu`; the dither's quantizer through
`ops/quantize_kernels.py` (`csrc/error_feedback_quantize.cu`).

Device rule: every function that makes tensors takes an explicit
`device`; nothing picks one by itself.  A CPU tensor takes each kernel's
plain PyTorch version; a CUDA tensor takes the kernel or raises.
"""

__version__ = "0.1.0"
