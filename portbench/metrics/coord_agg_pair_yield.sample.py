"""coord_agg's pair yield over the traced part: 100 x the pairs inside the
cutoffs over the pairs its chunks compute, as its library counts them while
the profiler records (``ops.egnn_cuda.pair_counts``); None where the
program keeps no such counter."""


def read(record):
    from diffsbdd_tpu_torch.ops import egnn_cuda as ec
    counts = getattr(ec, "pair_counts", None)
    active, computed = counts().get("coord_agg", (0, 0)) if counts else (0, 0)
    if computed <= 0:
        return None
    return 100.0 * active / computed
