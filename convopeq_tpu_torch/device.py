"""Explicit device resolution and the port's stated numeric precision."""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cpu", "cuda", "cuda:0", or a device).

    "cuda" raises when no card is present: nothing falls back to the CPU.
    On a card this also states the float32 precision: no TF32 anywhere
    (nothing on the folded path is a matmul or a cuDNN convolution, but
    the port says what it computes in)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def card_description() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them for
    card 0.  Every measured number is stated beside it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]
