"""IR preparation (counterpart of convopeq_tpu/ir/): the resampler, the
IR analysis, minimum and mixed phase, the allpass designer and its
CMA-ES."""
from . import allpass, analyzer, cmaes, phase, resample  # noqa: F401
