"""Device time a training step outside its micro-batches, over the traced
part: the median ``train.step`` span's CUDA-event time less its
``train.micro_batch`` children's (``utils.profiling.snapshot``), i.e. the
gradient accumulation, the clipping, AmsgradW and the idle they leave.  None
where the program keeps no such span, or recorded no CUDA events."""


def read(record):
    from diffsbdd_tpu_torch.utils import profiling
    snapshot = getattr(profiling, "snapshot", None)
    value = (snapshot().get("train.step") or {}).get("device_self_median_s") \
        if snapshot else None
    return None if value is None else 1e3 * value
