"""The port's mesh and per-rank input (mst_tpu_torch/parallel) on the CPU:
the meshes a gloo world of 2 builds from --mesh_shape (names, ranks, each
rank's block of the batch); the node-aware hybrid layout on faked
hostnames (mst_tpu's slice-aware cases, tests/test_hybrid_mesh.py); the
refusals; the backend each rank picks from the ranks' cards; local_slice,
take_local and pad_batch_to_multiple; and sampling.Rows, whose rows draw
what a world of one draws for them, bit for bit, from a generator and
from a key.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from mst_tpu_torch import config
from mst_tpu_torch.ops import kmeans, sampling
from mst_tpu_torch.parallel import hostdata
from mst_tpu_torch.parallel import mesh as mesh_lib
from mst_tpu_torch.train import steps
from tests import torch_port_ranks as ranks


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_meshes_of_a_world_of_two(tmp_path):
    got = ranks.launch(tmp_path, [2], ["mesh"])["mesh"]
    for r, out in enumerate(got):
        assert out["backend"] == "gloo"
        names, ids, shard, count = out[(2,)]
        assert names == ("data",) and ids.tolist() == [0, 1]
        assert shard == (r, 2) and count == 2
        names, ids, shard, count = out[(1, 2)]
        assert names == ("replica", "data") and ids.tolist() == [[0, 1]]
        assert shard == (r, 2) and count == 2
        names, ids, shard, count = out[(2, 1)]
        assert ids.tolist() == [[0], [1]] and shard == (r, 2)


@pytest.mark.parametrize("case", ["full", "sub_node", "misaligned",
                                  "one_host"])
def test_hybrid_layout_is_node_aware(case):
    """Each 'replica' row on one host: a row a host (full), several rows a
    host with the hosts' ranks interleaved (sub-node); a shape that cannot
    align warns and takes row-major order; one host takes it silently."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if case == "full":
            rows = mesh_lib.hybrid_layout(["a"] * 4 + ["b"] * 4, 2, 4)
            assert rows.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
        elif case == "sub_node":
            rows = mesh_lib.hybrid_layout(["a", "b"] * 4, 4, 2)
            assert rows.tolist() == [[0, 2], [4, 6], [1, 3], [5, 7]]
        elif case == "misaligned":
            rows = mesh_lib.hybrid_layout(["a"] * 3 + ["b"] * 3, 3, 2)
            assert rows.tolist() == [[0, 1], [2, 3], [4, 5]]
        else:
            rows = mesh_lib.hybrid_layout(["a"] * 8, 2, 4)
            assert rows.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    crossing = [w for w in caught if "may cross hosts" in str(w.message)]
    assert len(crossing) == (case == "misaligned")


def test_mesh_refusals():
    """The spatial mesh (not ported, naming the next slice), a shape that
    is not the world (this process is a world of 1), --mesh_axes that do
    not match the shape or are unknown, a 3-D shape; none starts a
    process group."""
    with pytest.raises(NotImplementedError, match="next slice"):
        mesh_lib.mesh_from_shape([1, 1], ["data", "space"], "cpu")
    with pytest.raises(NotImplementedError, match="next slice"):
        config.check_loop_ported({"mesh_axes": ["data", "space"]})
    with pytest.raises(ValueError, match="spans 4 ranks but the world has 1"):
        mesh_lib.mesh_from_shape([2, 2], None, "cpu")
    with pytest.raises(ValueError, match="must match"):
        mesh_lib.mesh_from_shape([2], ["replica", "data"], "cpu")
    with pytest.raises(ValueError, match="unsupported --mesh_axes"):
        mesh_lib.mesh_from_shape([2], ["model"], "cpu")
    with pytest.raises(ValueError, match="1 or 2 values"):
        mesh_lib.mesh_from_shape([1, 1, 1], None, "cpu")
    assert mesh_lib.mesh_from_shape(None) is None
    assert not torch.distributed.is_initialized()


def test_local_slice_covers_the_batch():
    slices = [hostdata.local_slice(32, i, 4) for i in range(4)]
    assert slices[0] == (0, 8) and slices[-1] == (24, 32)
    assert sorted(i for lo, hi in slices for i in range(lo, hi)) == \
        list(range(32))
    assert hostdata.local_slice(8) == (0, 8)  # a world of 1
    with pytest.raises(ValueError, match="does not split over 3"):
        hostdata.local_slice(8, 0, 3)


def test_take_local_keeps_scene_keys_whole():
    b = {"traj": np.arange(32.0).reshape(8, 2, 2), "mask": np.ones(8),
         "scene_idx": np.arange(8), "semantic": np.ones((2, 4, 4, 3)),
         "image": np.ones((1, 4, 4, 3)), "homography": np.eye(3)}
    local = hostdata.take_local(b, 1, 4)
    np.testing.assert_array_equal(local["traj"], b["traj"][2:4])
    np.testing.assert_array_equal(local["scene_idx"], [2, 3])
    for k in mesh_lib.REPLICATED_KEYS:
        assert local[k] is b[k]


def test_pad_batch_to_multiple_pads_every_row_key():
    b = {"traj": np.ones((5, 3, 2), np.float32),
         "mask": np.ones(5, np.float32), "scene_idx": np.arange(5),
         "semantic": np.ones((1, 4, 4, 3), np.float32)}
    out = mesh_lib.pad_batch_to_multiple(b, 4)
    assert out["traj"].shape == (8, 3, 2) and out["mask"].sum() == 5
    assert out["scene_idx"].tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    assert out["semantic"] is b["semantic"]
    assert mesh_lib.pad_batch_to_multiple(out, 4) is out


@pytest.mark.parametrize("cards, want", [
    # a card a rank, each rank seeing only its own (one visible device)
    (["h0/GPU-a", "h0/GPU-b", "h0/GPU-c", "h0/GPU-d"], "nccl"),
    (["h0/GPU-a", "h1/GPU-b"], "nccl"),
    # two ranks on one card
    (["h0/GPU-a", "h0/GPU-a"], "gloo"),
    (["h0/GPU-a", "h1/GPU-b", "h1/GPU-b"], "gloo"),
])
def test_backend_from_the_ranks_cards(monkeypatch, cards, want):
    """Every rank, run as a thread on one store, picks NCCL exactly when no
    two ranks hold one card, whatever the ranks' device counts say."""
    world = len(cards)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(world))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mine = threading.local()
    monkeypatch.setattr(mesh_lib, "card_id", lambda device: mine.card)
    store, got = torch.distributed.HashStore(), [None] * world

    def rank(r):
        mine.card = cards[r]
        got[r] = mesh_lib.choose_backend("cuda", store, r, world)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert got == [want] * world


def test_backend_on_the_cpu_is_gloo():
    assert mesh_lib.choose_backend("cpu", None, 0, 2) == "gloo"


def rows_of(fn, n=6, blocks=((0, 2), (2, 4), (4, 6))):
    """fn(draws) on the global batch with draws from seed 11, and on each
    block of rows through sampling.Rows -> (global, [block outputs])."""
    whole = fn(torch.Generator().manual_seed(11), slice(None))
    parts = [fn(sampling.Rows(torch.Generator().manual_seed(11), lo, hi, n),
                slice(lo, hi)) for lo, hi in blocks]
    return whole, parts


@pytest.mark.parametrize("replacement", [False, True])
def test_rows_sample_a_heatmap_as_one_process(replacement):
    maps = torch.rand((6, 2, 16, 24), generator=torch.Generator()
                      .manual_seed(0))

    def fn(gen, rows):
        return sampling.sample_heatmap(maps[rows], 7, rel_threshold=0.05,
                                       replacement=replacement,
                                       generator=gen)

    whole, parts = rows_of(fn)
    for (lo, hi), part in zip(((0, 2), (2, 4), (4, 6)), parts):
        assert torch.equal(part, whole[lo:hi])


@pytest.mark.parametrize("source", ["generator", "key"])
def test_rows_draw_kmeans_as_one_process(source):
    """k-means' initial picks and reseeds by global row, from a generator
    (the key it draws) and from a key."""
    points = torch.rand((6, 50, 2), generator=torch.Generator()
                        .manual_seed(1)) * 30

    def fn(gen, rows):
        if source == "key":
            gen = (sampling.Key(sampling.key_from_seed(4))
                   if isinstance(gen, torch.Generator) else sampling.Rows(
                       sampling.Key(sampling.key_from_seed(4)), gen.lo,
                       gen.hi, gen.n))
        return kmeans.batched_kmeans(points[rows], 4, generator=gen)[1]

    whole, parts = rows_of(fn)
    for (lo, hi), part in zip(((0, 2), (2, 4), (4, 6)), parts):
        assert torch.equal(part, whole[lo:hi])


def test_rows_draw_cws_as_one_process():
    """CWS draws its waypoints on (K, B, H, W) maps: the batch on dim 1."""
    params = config.get_params("sdd_shortterm_train.yaml", dict(
        waypoints=[3, 7, 11], n_goal=3, n_traj=2, use_CWS=True,
        CWS_params=dict(sigma_factor=6, ratio=2, rot=True)))
    scfg = config.step_config(params)
    g = torch.Generator().manual_seed(2)
    goals = torch.rand((3, 6, 1, 2), generator=g) * 20 + 2
    traj = torch.rand((6, 20, 2), generator=g) * 20 + 2
    maps = torch.rand((6, 3, 24, 24), generator=g)

    def fn(gen, rows):
        return steps._cws(gen, goals[:, rows], traj[rows], maps[rows], scfg)

    whole, parts = rows_of(fn)
    for (lo, hi), part in zip(((0, 2), (2, 4), (4, 6)), parts):
        assert torch.equal(part, whole[:, lo:hi])
