"""gcl_agg_bwd's share of its 3xTF32 roofline over the traced part: the sum
of its launches' least times (``work.Launch.least_s``: the pairs inside the
cutoffs in each launch's inputs) over its device time in the trace (its
function and its library's helper kernels)."""


def read(record):
    trace = record.get("trace") or {}
    spent = trace.get("kernel_s", {}).get("gcl_agg_bwd", 0.0)
    least = record.get("kernel_least_s", {}).get("gcl_agg_bwd", 0.0)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
