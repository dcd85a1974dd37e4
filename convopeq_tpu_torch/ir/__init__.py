"""IR preparation (counterpart of convopeq_tpu/ir/): the resampler and
the planner's IR analysis."""
from . import analyzer, resample  # noqa: F401
