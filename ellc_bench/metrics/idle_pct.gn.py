"""The device's idle share of the traced pass: the part of its span in
which no kernel, memset or copy ran (``trace.py``: the union of the device
intervals)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
