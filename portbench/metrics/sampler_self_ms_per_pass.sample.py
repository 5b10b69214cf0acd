"""Device time a sampler pass outside the network, over the traced part:
the median ``sampler.pass`` span's CUDA-event time less its
``network.forward`` child's (``utils.profiling.snapshot``), i.e. the
sampler's own kernels and the idle its Python leaves between networks.  The
median, since the pass in which the traced part switches from the device
trace to the host trace holds that switch's export.  None where the program
keeps no such span, or recorded no CUDA events."""


def read(record):
    from diffsbdd_tpu_torch.utils import profiling
    snapshot = getattr(profiling, "snapshot", None)
    value = (snapshot().get("sampler.pass") or {}).get("device_self_median_s") \
        if snapshot else None
    return None if value is None else 1e3 * value
