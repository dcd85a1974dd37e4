"""Host seconds of set-up in loading the CUDA libraries, nvcc included
where a library was not built yet (the program's "setup.build" span)."""
from benchmark import spans


def read(ctx):
    return spans.setup_seconds("setup.build")
