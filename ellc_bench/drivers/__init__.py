"""The entry points a benchmark window drives, one file each.

A driver file defines ``Driver(config, traffic, seed, device)`` with:

- ``RATE_METRIC``: the end-to-end rate it measures (frames over the
  window's seconds);
- ``setup()``: the inputs from the seed, on the device, and one warm pass;
- ``run_pass(spans, counters)``: one pass of the timed path, its outputs
  read back; returns the frames it completed, and adds host seconds by
  name to ``spans`` and counts to ``counters``;
- ``pass_work()``: what one pass does (frames, steps, aligns), for the
  per-layer metrics;
- ``report_lines()``: lines for standard error (accuracy against the
  ground truth);
- ``release()``: frees the program's state;
- ``check(limits)``: the comparison with the plain reference, a list of
  (name, value, limit);
- ``attempted`` and ``failed``: the requests (videos) of the
  window.
"""
