"""The benchmark of convopeq_tpu_torch on one NVIDIA H100: offline render
and real-time block serving, run as cells that BENCHMARK.json names and
the files under this folder describe.  `python3 -m benchmark.run` runs
one cell once; see harness.py for how a cell is found."""
