"""Host seconds of set-up in the host fold of the IR and its spectra to
the device (the program's "setup.fold" span)."""
from benchmark import spans


def read(ctx):
    return spans.setup_seconds("setup.fold")
