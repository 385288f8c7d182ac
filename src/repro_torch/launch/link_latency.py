"""The time of one small message between two GPUs on the device: an NCCL
send/receive ping-pong between ranks 0 and 1 (one GPU each), timed with
CUDA events — the figure behind ``launch.analytic.NVLINK_LATENCY``, the
dry run's per-message latency.  Also the device time of a small NCCL
all-reduce over every GPU, and both again on the host clock, as an
eager program pays them.

    python -m repro_torch.launch.link_latency

It needs two GPUs or more (``ValueError`` otherwise) and prints one
JSON line.  The device figures hide the host: each rank's stream first
sleeps (``torch.cuda._sleep``) while the host queues ``SHORT`` or
``LONG`` back-to-back messages behind it, and the events around them
time the device alone (the JSON says ``launches_hidden: false``, and
the exit code is 1, if a sleep ended before the last launch was
queued).  The difference of the two lengths, over
``LONG - SHORT`` round trips and halved, is the one-way latency: a
fixed cost (the ranks' skew after their barrier) cancels.  The median
over ``REPS`` pairs is reported.  The host-clock figures are the median
of ``ITERS`` round trips from the send to the synchronised receive
(launches and the synchronisation included), halved.  Every figure
comes with the cards' ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import datetime
import json
import socket
import statistics
import subprocess
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: the message (bytes), the host-clock round trips, the warm-up trips
BYTES = 4
ITERS = 2000
WARMUP = 100
#: round trips queued behind one sleep, and the pairs of runs timed
SHORT, LONG = 20, 100
REPS = 20
#: the stream's sleep while the host queues LONG round trips (~0.2 s at
#: the H100's 1.98 GHz boost clock)
SLEEP_CYCLES = 400_000_000
#: seconds a rank waits on another before it fails
TIMEOUT_S = 90


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _device_ms(op, n: int) -> tuple[float, bool]:
    """Device milliseconds of ``n`` back-to-back ``op()`` calls, queued
    behind a sleep of the stream so that no launch waits for the host,
    and whether the sleep outlasted the queueing."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(n):
        op()
    end.record()
    hidden = not start.query()
    end.synchronize()
    return start.elapsed_time(end), hidden


def _per_op_s(op) -> tuple[float, bool]:
    """The median over REPS of (LONG − SHORT calls' device time) per
    call, and whether every launch was hidden behind its sleep."""
    diffs, hidden = [], True
    for _ in range(REPS):
        dist.barrier()
        short, h1 = _device_ms(op, SHORT)
        dist.barrier()
        long, h2 = _device_ms(op, LONG)
        diffs.append((long - short) / (LONG - SHORT) / 1e3)
        hidden = hidden and h1 and h2
    return statistics.median(diffs), hidden


def _host_s(op) -> float:
    """The median host-clock time of one synchronised ``op()``."""
    times = []
    for i in range(WARMUP + ITERS):
        if i == WARMUP:
            dist.barrier()
        t0 = time.perf_counter()
        op()
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _rank(rank: int, world: int, port: int, out) -> None:
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        buf = torch.zeros(BYTES, dtype=torch.uint8, device="cuda")
        flag = torch.zeros(1, dtype=torch.int32, device="cuda")

        def ping():
            if rank == 0:
                dist.send(buf, 1)
                dist.recv(buf, 1)
            elif rank == 1:
                dist.recv(buf, 0)
                dist.send(buf, 0)

        def reduce():
            dist.all_reduce(flag)

        for _ in range(WARMUP):       # the communicators made first
            ping()
            reduce()
        torch.cuda.synchronize()
        trip, h1 = _per_op_s(ping)
        red, h2 = _per_op_s(reduce)
        res = {"one_way_s": trip / 2, "all_reduce_s": red,
               "launches_hidden": h1 and h2,
               "eager_one_way_s": _host_s(ping) / 2,
               "eager_all_reduce_s": _host_s(reduce)}
        if rank == 0:
            out.put(res)
    finally:
        dist.destroy_process_group()


def measure() -> dict:
    world = torch.cuda.device_count()
    if world < 2:
        raise ValueError(f"a link needs two GPUs; this machine has {world}")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 2 * TIMEOUT_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"ranks exited {[p.exitcode for p in procs]}")
    res = out.get(timeout=10)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return {**res, "gpus": world, "bytes": BYTES, "round_trips":
            [SHORT, LONG], "reps": REPS, "host_iters": ITERS,
            "nvidia_smi": smi}


def main() -> int:
    res = measure()
    print(json.dumps(res))
    return 0 if res["launches_hidden"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
