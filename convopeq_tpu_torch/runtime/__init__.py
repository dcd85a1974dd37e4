"""The serving runtime (counterpart of convopeq_tpu/runtime/): the
streaming step, the crossfade plane and telemetry."""
from . import crossfade, streaming, telemetry  # noqa: F401
