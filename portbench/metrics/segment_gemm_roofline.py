"""segment_gemm's share of its roofline, %: the least time of every
launch in the traced passes (roofline.py) over the profiler's time of
those launches. Nothing where the trace holds another launch count
than the passes made."""

from portbench import roofline


def read(ctx):
    tr, classes = ctx.tracer, ctx.state.get("classes")
    if tr is None or not classes or not tr.intervals:
        return None
    passes = 2 if ctx.config["consensus"].get("error_model") == "cycle" else 1
    bound = 0.0
    for c in classes:
        bks, spec = c["buckets"], c["spec"]
        rows, l = bks[0].capacity, bks[0].bases.shape[1]
        live = sum(int(bk.valid.sum()) for bk in bks)
        for fit in (True, False)[2 - passes:]:
            bound += roofline.segment_gemm_seconds(len(bks), rows, spec.f_max or rows,
                                                   roofline.ssc_columns(l, fit), live)
    seconds, launches = tr.kernel_seconds("segment_gemm_kernel")
    if launches != passes * len(classes) * ctx.attempted or seconds <= 0:
        return None
    return 100.0 * bound * ctx.attempted / seconds
