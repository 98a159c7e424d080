"""K2's share of its roofline over the traced pass: 70 B a pixel a video a
``track_refine`` step and 32 B a video (``roofline/work.py::stereo_work``)
for every such step of the pass, over the traced device time of
``stereo_observe``."""

from ellc_bench.roofline import peaks, work


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    if tr is None or not w.get("track_refine_steps"):
        return None
    t = tr.kernel_s("stereo_observe")
    if t <= 0:
        return None
    nbytes, ops = work.stereo_work(w["rows"], w["cols"], w["videos"])
    steps = w["track_refine_steps"]
    return 100.0 * peaks.bound_s(nbytes * steps, ops * steps) / t
