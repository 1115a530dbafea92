"""The mean time of `Predictor.forward` (encoder, goal decoder, sampling
with TTST and CWS) over the traced run's requests, each timed from a
synchronise to a synchronise; the profiled requests are left out."""


def read(record):
    spans = record.get("spans")
    if not spans:
        return None
    return 1e3 * sum(f for f, _ in spans) / len(spans)
