"""Host seconds of set-up in the engine's IR loader: trim, energy scale,
analysis and the NUC's spectra to the device (the program's
"setup.load" span); None where the program never opened one."""
from benchmark import spans


def read(ctx):
    return spans.setup_seconds("setup.load") or None
