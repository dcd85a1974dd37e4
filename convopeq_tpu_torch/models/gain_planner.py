"""Processing-order constants (counterpart of
convopeq_tpu/models/gain_planner.py:19-21).  The AutoGainPlanner itself
is ported with oversampling (ROADMAP.md section 1, item 2)."""

# ProcessingOrder (src/audioengine: enum) — Convolver first vs EQ first
CONVOLVER_THEN_EQ = 0
EQ_THEN_CONVOLVER = 1
