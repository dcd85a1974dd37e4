"""convopeq_tpu_torch — the PyTorch and CUDA counterpart of `convopeq_tpu`.

The same module paths and function names as the JAX package, so each
counterpart is found at once.  This package imports `torch` and never
`jax`.  It holds the folded throughput chain (`models/chain.py`:
`prepare_folded_convolver` + `process_chain_fused`, `headline.py`), the
semi-folded render chain with dither (`config6.py`), and the reference
3-layer convolver with the fused-prefilter chain (`models/nuc.py`,
`models/convolver.py`, `nuc3.py`), each in f32 and in native f64, the
<=1e-9 tier (`parity.py`: the JAX package's f64 parity lines), and the
staged chain at 1x (`models/chain.py` `process_chain`, `staged.py`: the
EQ's band cascade and combined response, the AGC, the output filter's
biquad scans and the analyzer's STFT as signal passes), and the serving
runtime (`runtime/streaming.py` `StreamingChain`, the block-at-a-time
step with its state, staged or folded, in f32, f16 delay line or f64;
`runtime/crossfade.py`, `runtime/telemetry.py`; `serve.py`), and the
application path: `engine/engine.py` `ConvoPeqEngine` (the IR loader with
minimum and mixed phase, `process`, `process_streaming`, presets) and the
CLI (`python -m convopeq_tpu_torch.cli`), with the metering, limiter,
analyzer view and IR preparation they run.  Their
overlap-save partitioned convolutions run on an NVIDIA H100 through
hand-written CUDA kernels: three frame kernels in f32 and in f64, and the
forward of materialized frames (`ops/frame_conv_kernels.py`), and the f32
fused kernel for layers of <= 8 partitions (`ops/fused_conv_kernels.py`),
all from `csrc/frame_conv.cu`; the dither's quantizer through
`ops/quantize_kernels.py` (`csrc/error_feedback_quantize.cu`).

Device rule: every function that makes tensors takes an explicit
`device`; nothing picks one by itself.  A CPU tensor takes each kernel's
plain PyTorch version; a CUDA tensor takes the kernel or raises.
"""

__version__ = "0.1.0"
