"""The harness that starts a mesh's ranks as processes, as torchrun would
(chip_smoke.launch_ranks, under chip_smoke.start_ranks and
tests/torch_port_ranks.start): every rank's stdout and stderr go to files,
so a rank that prints more than a pipe's buffer (64 KiB) while the parent
waits on another rank does not block in write() and stop the world in its
next collective; a rank past the job's limit leaves its output and a
dump of every thread's stack (chip_smoke.arm_rank_dumps), and the failure
shows every rank's tail; NCCL's flight recorder dumps are summarised by
process group."""

import os
import pickle
import sys

import pytest

import chip_smoke
from tests import torch_port_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BYTES = 1 << 18  # four times a pipe's buffer

# rank 1 writes BYTES to stdout and to stderr, then signals rank 0 through
# a file, as a collective would; rank 0 waits for the signal
LOUD = f"""
import os, sys, time
sys.path.insert(0, {REPO!r})
import chip_smoke
chip_smoke.arm_rank_dumps()
ready = os.path.join(sys.argv[1], "ready")
if os.environ["RANK"] == "1":
    sys.stdout.write("o" * {BYTES}); sys.stdout.flush()
    sys.stderr.write("e" * {BYTES}); sys.stderr.flush()
    open(ready, "w").close()
else:
    while not os.path.exists(ready):
        time.sleep(0.05)
print("rank", os.environ["RANK"], "done", flush=True)
"""

# each rank says it started, then waits in a thread and in its main thread
# past the job's limit (arming the dumps there, so that they find it
# waiting however long the start took)
STUCK = f"""
import os, sys, threading, time
sys.path.insert(0, {REPO!r})
import chip_smoke
print("rank", os.environ["RANK"], "started", flush=True)
def waits_in_a_thread():
    time.sleep(120)
def waits_in_main():
    chip_smoke.arm_rank_dumps()
    time.sleep(120)
threading.Thread(target=waits_in_a_thread, daemon=True).start()
waits_in_main()
"""


def test_ranks_outprinting_a_pipe_finish(tmp_path):
    wait = chip_smoke.launch_ranks(
        2, [sys.executable, "-c", LOUD, str(tmp_path)], 60,
        str(tmp_path / "logs"))
    (out0, err0), (out1, err1) = wait()
    assert out0 == "rank 0 done\n" and err0 == ""
    assert out1 == "o" * BYTES + "rank 1 done\n" and err1 == "e" * BYTES
    assert sorted(os.listdir(tmp_path / "logs")) == [
        "rank0.err", "rank0.out", "rank1.err", "rank1.out"]


def test_rank_past_its_limit_leaves_output_and_stacks(tmp_path):
    # the job's limit 8 s, its margin 2 s: each rank dumps at 6 s
    wait = chip_smoke.launch_ranks(2, [sys.executable, "-c", STUCK], 8,
                                   str(tmp_path / "logs"))
    with pytest.raises(AssertionError) as failed:
        wait()
    msg = str(failed.value)
    assert "a world of 2 failed after" in msg
    for r in (0, 1):
        assert f"rank {r} started" in msg
        with open(tmp_path / "logs" / f"rank{r}.err") as f:
            err = f.read()
        # faulthandler's dump of every thread, the main one and the other
        assert "Timeout (0:00:0" in err
        assert "waits_in_main" in err and "waits_in_a_thread" in err
        assert err.count("(most recent call first)") >= 2
    assert "waits_in_a_thread" in msg


def test_failed_rank_ends_the_world(tmp_path):
    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1':\n"
            "    sys.exit('rank 1 gives up')\n"
            "time.sleep(120)\n")
    # the job's limit 8 s, its margin 2 s after rank 1 failed
    wait = chip_smoke.launch_ranks(2, [sys.executable, "-c", code], 8,
                                   str(tmp_path / "logs"))
    with pytest.raises(AssertionError) as failed:
        wait()
    msg = str(failed.value)
    assert "-- rank 1: exit 1" in msg and "rank 1 gives up" in msg
    assert "-- rank 0: exit -9" in msg  # killed, not left to its limit
    assert float(msg.split("failed after ")[1].split(" s")[0]) < 7


def test_torch_port_ranks_keep_a_loud_world(tmp_path):
    got = ranks.launch(tmp_path, [2], ["loud"], timeout=120, threads=1)
    assert got["loud"] == [0, 1]
    for r in (0, 1):
        with open(tmp_path / "ranks" / f"rank{r}.out") as f:
            assert f.read().count("o") >= ranks.LOUD_BYTES
        with open(tmp_path / "ranks" / f"rank{r}.err") as f:
            assert f.read().count("e") >= ranks.LOUD_BYTES


def test_flight_summary_names_each_group_last_collectives(tmp_path):
    def entry(pg, seq, name, state):
        return {"process_group": pg, "collective_seq_id": seq,
                "profiling_name": name, "input_sizes": [[4, 8]],
                "state": state}

    dump = {"version": "2.4", "pg_config": {}, "entries": [
        entry(("0", "default_pg"), 1, "nccl:all_reduce", "completed"),
        entry(("1", "mesh_space"), 1, "nccl:all_reduce", "completed"),
        entry(("1", "mesh_space"), 2, "nccl:all_reduce", "scheduled"),
        entry(("0", "default_pg"), 2, "nccl:barrier", "started")]}
    path = tmp_path / (chip_smoke.NCCL_TRACE + "0")
    with open(path, "wb") as f:
        pickle.dump(dump, f)
    lines = chip_smoke.flight_summary(str(path))
    assert lines == [
        "  pg 0:default_pg: #1 nccl:all_reduce [[4, 8]] completed; "
        "#2 nccl:barrier [[4, 8]] started",
        "  pg 1:mesh_space: #1 nccl:all_reduce [[4, 8]] completed; "
        "#2 nccl:all_reduce [[4, 8]] scheduled"]


def test_ranks_get_the_dump_settings(tmp_path):
    code = ("import json, os\n"
            "print(json.dumps({k: os.environ.get(k) for k in ("
            "'TORCH_FR_BUFFER_SIZE', 'TORCH_NCCL_DUMP_ON_TIMEOUT', "
            "'TORCH_NCCL_DEBUG_INFO_TEMP_FILE', 'P14_PG_TIMEOUT_S', "
            "'P14_LOGS', 'CUDA_VISIBLE_DEVICES', 'RANK', 'WORLD_SIZE')}))\n")
    import json

    logs = str(tmp_path / "logs")
    texts = chip_smoke.launch_ranks(2, [sys.executable, "-c", code], 60,
                                    logs, own_card=True)()
    for r, (out, _) in enumerate(texts):
        env = json.loads(out)
        assert env == {
            "TORCH_FR_BUFFER_SIZE": "2000",
            "TORCH_NCCL_DUMP_ON_TIMEOUT": "1",
            "TORCH_NCCL_DEBUG_INFO_TEMP_FILE": os.path.join(
                logs, chip_smoke.NCCL_TRACE),
            "P14_PG_TIMEOUT_S": "30.0", "P14_LOGS": logs,
            "CUDA_VISIBLE_DEVICES": str(r), "RANK": str(r),
            "WORLD_SIZE": "2"}
