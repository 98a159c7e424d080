"""K1's share of its roofline over the traced pass: the bound of every
align the pass made (``roofline/work.py::align_work``, each level's planes
counted once an align a video: the least an align reads, so the share is
not overstated) over the traced device time of ``gn_level_cluster`` and
``gn_step``."""

from ellc_bench.roofline import peaks, work


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    if tr is None or not w.get("aligns"):
        return None
    t = tr.kernel_s("gn_level_cluster|gn_step")
    if t <= 0:
        return None
    nbytes, ops = work.align_work(w["rows"], w["cols"], w["levels"],
                                  w["aligns"])
    return 100.0 * peaks.bound_s(nbytes, ops) / t
