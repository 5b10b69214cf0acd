"""Sampler wall a network pass: the sampler's spans (around
``sample_given_pocket``, ending in a synchronise) over their passes (T steps
and the decode a request), over the untraced requests."""


def read(record):
    smp = (record.get("spans") or {}).get("sampler", [])
    if not smp:
        return None
    return 1e3 * sum(smp) / (len(smp) * record["passes_per_request"])
