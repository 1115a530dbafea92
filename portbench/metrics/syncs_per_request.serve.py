"""Host synchronisations a request makes, as
torch.cuda.set_sync_debug_mode('warn') reports them (k-means' convergence
test reads a flag each iteration), averaged over the traced run's
requests outside the profiled ones."""


def read(record):
    syncs = record.get("syncs")
    if not syncs:
        return None
    return sum(syncs) / len(syncs)
