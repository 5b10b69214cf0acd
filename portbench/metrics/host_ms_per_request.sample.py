"""Host time a request outside the sampler: the request's wall (around
``generate_ligands``) less the sampler's (around ``sample_given_pocket``,
ending in a synchronise), over the untraced requests: pocket preparation,
PDB parsing and molecule building."""


def read(record):
    spans = record.get("spans") or {}
    req, smp = spans.get("request", []), spans.get("sampler", [])
    if not req or len(req) != len(smp):
        return None
    return 1e3 * sum(r - s for r, s in zip(req, smp)) / len(req)
