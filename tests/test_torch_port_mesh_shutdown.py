"""The port's teardown of a world (parallel/mesh.shutdown): every CUDA
graph still alive is freed (ops/kernels/launches.release_graphs) before
the process groups are destroyed, since NCCL cannot destroy a
communicator while a graph that captured its collectives lives (a
--fused run on a spatial mesh of 4 cards then waited in
destroy_process_group on every rank for ever). The hang itself needs
NCCL across cards: `python -m mst_tpu_torch.probes.graph_teardown` shows
it there. Here, on the CPU, a stand-in for torch.cuda.CUDAGraph records
the order, in a gloo world of one."""

import torch.distributed as dist

from mst_tpu_torch.ops.kernels import launches
from mst_tpu_torch.parallel import mesh as mesh_lib


class StandIn:
    """What launches.Graph needs of a torch.cuda.CUDAGraph here."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def reset(self):
        self.log.append(f"reset {self.name}")


def captured(log, name):
    """A launches.Graph that captured (registered as alive), on a
    stand-in."""
    graph = launches.Graph.__new__(launches.Graph)
    graph.graph, graph.per_replay = StandIn(log, name), {("f", "n"): 2}
    launches._LIVE.add(graph)
    return graph


def test_shutdown_frees_the_graphs_before_the_groups(monkeypatch):
    log = []
    mesh_lib.init_process_group("cpu")
    try:
        graphs = [captured(log, "a"), captured(log, "b")]
        destroy = dist.destroy_process_group

        def destroyed(*a, **k):
            log.append("destroy")
            return destroy(*a, **k)

        monkeypatch.setattr(dist, "destroy_process_group", destroyed)
        mesh_lib.shutdown()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert sorted(log[:2]) == ["reset a", "reset b"] and log[2:] == [
        "destroy"]
    assert not dist.is_initialized() and not list(launches._LIVE)
    # what the graphs counted stays readable
    assert all(g.per_replay == {("f", "n"): 2} for g in graphs)


def test_shutdown_without_a_world_does_nothing():
    assert not dist.is_initialized()
    mesh_lib.shutdown()
    assert not dist.is_initialized()


def test_release_graphs_frees_each_graph_once():
    log = []
    graph = captured(log, "a")
    launches.release_graphs()
    launches.release_graphs()  # nothing left alive
    assert log == ["reset a"] and graph not in launches._LIVE
