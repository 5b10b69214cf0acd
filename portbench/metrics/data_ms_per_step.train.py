"""Host time a step in the loader's assembly and padding of its batch, over
the traced part: the mean ``data.batch`` span (``utils.profiling.snapshot``),
the program's own twin of ``loader_ms_per_step.train``.  None where the
program keeps no such span."""


def read(record):
    from diffsbdd_tpu_torch.utils import profiling
    snapshot = getattr(profiling, "snapshot", None)
    batch = (snapshot().get("data.batch") or {}) if snapshot else {}
    if not batch.get("count"):
        return None
    return 1e3 * batch["host_s"] / batch["count"]
