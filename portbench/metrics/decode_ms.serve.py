"""The mean time of `Predictor.decode` (the K trajectory decodes, to the
host copy of the trajectories) over the traced run's requests; the
profiled requests are left out."""


def read(record):
    spans = record.get("spans")
    if not spans:
        return None
    return 1e3 * sum(d for _, d in spans) / len(spans)
