"""The systems under test, one module a system, which a configuration
names by its "system" key: `benchmark/systems/<system>.py`.

A module gives, for the traffic kinds it serves:
- render: `render(cfg, ir, device)`, an object with `call(x, u=None)`
  (one offline call on a batch (B, 2, N); with the dither's uniforms u
  it returns what the check reads) and `shapes(inputs)` (the dict the
  per-layer readers read as ctx["render"]); and
  `check_render(cfg, ir, inputs, outputs, seed)`;
- live: `live(cfg, ir, device, fdl_dtype)`, an object with
  `block_size`, `layers` [(part size, partitions, blocks between
  fires)], `init_state(streams)` and `step(state, block)`; and
  `check_live(cfg, ir, feed, keep, kept, n_window, dev)`;
- `launch_counts()`: the launch counters of the kernels it runs;
- optionally `control_render(cfg, ir, inputs, seed)`: the numbers of its
  lower-precision control (`benchmark/control.py`).

Each check returns the numbers that the configuration's limits judge.
The harness refuses a cell whose system lacks its kind's functions.
"""
