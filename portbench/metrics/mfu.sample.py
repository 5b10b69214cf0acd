"""The model's operations over the traced part (``work``: each product
once, the pair MLPs at the pairs inside the cutoffs) over its length
times the 3xTF32 peak (``peaks.TF32X3_FLOPS``)."""

from portbench import peaks


def read(record):
    trace = record.get("trace") or {}
    if not trace.get("busy_s") or not trace.get("window_s"):
        return None
    return 100.0 * record["model_flops"] / (trace["window_s"] * peaks.TF32X3_FLOPS)
