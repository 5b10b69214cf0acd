"""Host time a step in the loader's ``next()`` (padding a batch)."""


def read(record):
    spans = (record.get("spans") or {}).get("loader", [])
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
