"""Does a world of NCCL ranks tear down while a CUDA graph that captured
their collectives lives?

    python -m mst_tpu_torch.probes.graph_teardown    # 2 or more CUDA cards

Each case starts a world of one rank a card (NCCL) through the port's
mesh.init_process_group, as torchrun would. Every rank all-reduces a
4 MiB buffer once eagerly, captures the same all-reduce in a CUDA graph
(ops/kernels/launches.Graph, as --fused captures the halo all-reduces),
replays it 3 times and checks the sum. Then it ends as its case says:
- 'shutdown': mesh.shutdown(), the port's teardown
  (launches.release_graphs, then destroy_process_group());
- 'exit': the process exits with the graph alive and the groups up;
- 'alive': destroy_process_group() with the graph alive.
A world that has not ended LIMIT s after its start is killed. Prints the
cards' names and power limits, then each case's seconds or 'hung', with
each rank's last lines; exits 1 if the port's teardown hung.
"""

import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

CASES = ("shutdown", "exit", "alive")
LIMIT = 60.0
N = 1 << 20  # f32 elements a rank all-reduces


def rank(case):
    """One rank of a case's world (RANK, WORLD_SIZE, MASTER_* set)."""
    import torch.distributed as dist

    from mst_tpu_torch.ops.kernels import launches
    from mst_tpu_torch.parallel import mesh

    backend = mesh.init_process_group("cuda")
    if backend != "nccl":
        raise SystemExit(f"the ranks share a card: backend {backend}")
    x = torch.ones(N, device="cuda")
    dist.all_reduce(x)  # NCCL's communicator, outside the capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = launches.Graph()
    graph.capture(lambda: dist.all_reduce(x), stream)
    x.fill_(1.0)
    for _ in range(3):
        graph.replay()
    world = dist.get_world_size()
    got = float(x[0])
    if got != world ** 3:
        raise SystemExit(f"3 replays gave {got}, not {world ** 3}")
    print(f"captured, 3 replays summed to {got}", flush=True)
    t0 = time.perf_counter()
    if case == "shutdown":
        mesh.shutdown()
    elif case == "alive":
        dist.destroy_process_group()
    print(f"{case}: torn down in {time.perf_counter() - t0:.2f} s",
          flush=True)


def world(case, n, tmp):
    """The case's world of n ranks -> (seconds or None if it hung, each
    rank's exit code and last lines)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = [os.path.join(tmp, f"{case}.rank{r}.log") for r in range(n)]
    procs = []
    for r, path in enumerate(paths):
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mst_tpu_torch.probes.graph_teardown",
                 "--rank", case],
                env=dict(env, RANK=str(r), LOCAL_RANK="0",
                         CUDA_VISIBLE_DEVICES=str(r)),
                cwd=root, stdout=f, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL))
    t0 = time.perf_counter()
    while any(p.poll() is None for p in procs) and \
            time.perf_counter() - t0 < LIMIT:
        time.sleep(0.2)
    secs = time.perf_counter() - t0
    hung = any(p.poll() is None for p in procs)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    tails = []
    for p, path in zip(procs, paths):
        with open(path, errors="replace") as f:
            tails.append((p.returncode, f.read().strip().splitlines()[-3:]))
    return (None if hung else secs), tails


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--rank":
        rank(sys.argv[2])
        return 0
    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"needs 2 or more CUDA cards, sees {n}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    ended = {}
    with tempfile.TemporaryDirectory() as tmp:
        for case in CASES:
            secs, tails = world(case, n, tmp)
            ended[case] = secs is not None and all(rc == 0
                                                   for rc, _ in tails)
            print(f"{case}, a world of {n}: "
                  + ("hung, killed" if secs is None
                     else f"ended in {secs:.1f} s")
                  + f" (limit {LIMIT:.0f} s)", flush=True)
            for r, (rc, lines) in enumerate(tails):
                print(f"  rank {r} exit {rc}: {' | '.join(lines)}")
    return 0 if ended["shutdown"] else 1


if __name__ == "__main__":
    sys.exit(main())
