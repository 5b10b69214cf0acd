"""The share of the traced part in which no operation ran on the device."""


def read(record):
    trace = record.get("trace") or {}
    if not trace.get("busy_s") or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
