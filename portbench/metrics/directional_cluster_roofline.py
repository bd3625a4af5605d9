"""directional_cluster's share of its roofline, %: the least time of
every launch in the traced passes (roofline.py, its pairs, molecules
and edges counted by the reference's grouping from each bucket's reads)
over the profiler's time of those launches. Nothing where no class
clusters, or the trace holds another launch count than the passes
made."""

from portbench import roofline
from portbench.reference.grouping import group_bucket

KERNEL = "directional_cluster_kernel"


def read(ctx):
    tr, classes = ctx.tracer, ctx.state.get("classes")
    if tr is None or not classes or not tr.intervals:
        return None
    clustering = [c for c in classes
                  if c["spec"].grouping.strategy in ("adjacency", "cluster")]
    if not clustering:
        return None
    words = roofline.umi_words(ctx.reads.umi.shape[1])
    bound = 0.0
    for c in clustering:
        tot = dict(pairs=0, mol_pairs=0, edges=0, unique=0)
        for bk in c["buckets"]:
            idx = bk.read_index[bk.valid] + c["a"]
            g = group_bucket(ctx.reads.pos[idx], ctx.reads.umi[idx], ctx.config["grouping"])
            for k in tot:
                tot[k] += g[k]
        bound += roofline.cluster_seconds(len(c["buckets"]), words, tot["pairs"],
                                          tot["mol_pairs"], tot["edges"], tot["unique"])
    seconds, launches = tr.kernel_seconds(KERNEL)
    if launches != len(clustering) * ctx.attempted or seconds <= 0:
        return None
    return 100.0 * bound * ctx.attempted / seconds
