"""The engine (counterpart of convopeq_tpu/engine/): `ConvoPeqEngine`, its
prepared-IR caches and the EQ analysis the gain planner reads."""
from .engine import ConvoPeqEngine  # noqa: F401
