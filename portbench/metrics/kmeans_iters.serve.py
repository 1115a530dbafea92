"""k-means iterations a request: the trip counts that `sampling.kmeans`
notes as `iterations`, summed over a profiled request's forward and
averaged over the profiled requests' `forward` spans."""

from portbench import spans


def read(record):
    return spans.per_top(record, "forward", "sampling.kmeans",
                         lambda s: s["attrs"].get("iterations", 0))
