"""The serving runtime (counterpart of convopeq_tpu/runtime/): the
streaming step, the crossfade plane and telemetry.  The submodules are
imported by name: the models and ops import `telemetry`'s spans, and
`streaming` imports the models."""
