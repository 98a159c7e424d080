"""K1's share of its roofline over the traced pass, against the work its
aligns did: ``roofline/work.py::align_work`` with each level's live
iterations an align, over the traced device time of ``gn_level_cluster``
and ``gn_step`` (``k1_roofline_pct`` counts one iteration a level, the
least an align does).  The live iterations come from the program's own
count on the card, ``utils/profiling.counters()["k1_live"]``: entry
[l][i] the videos not frozen at the start of iteration i of level l, so
``sum_i k1_live[l][i] / k1_live[l][0]`` is level l's live iterations an
align, over every align of the run.  None where the program keeps no such
count."""

from ellc_bench.roofline import peaks, work


def live_iters(levels):
    """Each level's live iterations an align (finest first) from the
    program's counts on its CUDA devices, or None."""
    from egomotion_with_local_loop_closures_tpu_torch.utils import profiling
    read = getattr(profiling, "counters", None)
    if read is None:
        return None
    tables = [t for dev, t in read().get("k1_live", {}).items()
              if dev.startswith("cuda")]
    out = []
    for level in range(levels):
        rows = [t[level] for t in tables if level < len(t)]
        first = sum(row[0] for row in rows)
        if first <= 0:
            return None
        out.append(sum(sum(row) for row in rows) / first)
    return out


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    if tr is None or not w.get("aligns"):
        return None
    t = tr.kernel_s("gn_level_cluster|gn_step")
    if t <= 0:
        return None
    live = live_iters(w["levels"])
    if live is None:
        return None
    nbytes, ops = work.align_work(w["rows"], w["cols"], w["levels"],
                                  w["aligns"], live_iters=live)
    return 100.0 * peaks.bound_s(nbytes, ops) / t
