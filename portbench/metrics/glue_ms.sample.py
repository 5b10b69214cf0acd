"""Device time a pass outside the port's kernels (cuBLAS, elementwise
and reduction kernels, copies, the optimizer), from the trace."""


def read(record):
    trace = record.get("trace") or {}
    n = record.get("passes", 0)
    if not trace.get("busy_s") or n <= 0:
        return None
    return 1e3 * trace["glue_s"] / n
