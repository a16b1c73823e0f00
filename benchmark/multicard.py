"""The ranks of a cell that runs on several cards: starting them, the groups
they join, the harness's messages between them, and the launcher that ends a
run when one of them fails.

A cell of `chips` n > 1 runs as n worker processes of the same script
(`run.py`, `calibrate.py`), one rank each, rank r on `cuda:r`.  The parent
holds the rendezvous (a TCP store on 127.0.0.1 at a port the system picks)
and waits; each rank joins

  * the default process group (NCCL on the cards, gloo on the CPU), which
    the loop gets for its collectives (`Ranks.group`), and
  * a gloo group on the CPU for the harness's own messages (`Ranks.ctrl`),
    so that the harness puts no kernel on a card's stream.

Every group has the same timeout, so a hung collective ends the rank with an
error.  A rank prints its log lines on standard output, which the parent
passes on (rank 0's as they are, the others' under "# rank r:"); rank 0
hands its result to the parent on one line that starts with `RESULT`.  The
parent ends the run, and kills the other ranks, as soon as one rank exits
with another code than 0.

A cell of one card starts no process and joins no group: its loop gets
`Ranks.one(device)`, whose `group` is None.
"""
from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import os
import signal
import subprocess
import sys
import threading
import time

HOST = "127.0.0.1"
# seconds that a collective, a barrier or the rendezvous may wait: longer
# than any rank's work between two of them (a cold scene build on rank 0
# while the others wait, the reference's check after the last one), and
# short enough that a hung NCCL collective, which its watchdog aborts about
# a minute after the timeout, ends the run inside its 360 s
GROUP_TIMEOUT_S = 180.0
RESULT = "RESULT "
POLL_S = 0.05
KILL_WAIT_S = 10.0


class Ranks:
    """One rank's place in its world: `rank`, `size`, its `device`, the
    loop's process group (`group`; None on one card) and the harness's gloo
    group (`ctrl`)."""

    def __init__(self, rank: int, size: int, device, group=None, ctrl=None):
        self.rank, self.size, self.device = rank, size, device
        self.group, self.ctrl = group, ctrl

    @staticmethod
    def one(device) -> "Ranks":
        """A world of one card: no process group."""
        return Ranks(0, 1, device)

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def barrier(self):
        import torch.distributed as dist

        dist.barrier(group=self.ctrl)

    def window_over(self, over: bool) -> bool:
        """Rank 0's `over` on every rank.  An all-reduce, so it returns on
        each rank only once every rank has called it: after a synchronized
        step, once the slowest rank's device is done."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(over and self.lead)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.ctrl)
        return bool(t.item())

    def gather(self, obj) -> list:
        """Every rank's `obj` (picklable), in rank order, on every rank."""
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.ctrl)
        return out

    def close(self):
        import torch.distributed as dist

        dist.destroy_process_group()


def join(rank: int, size: int, port: int, device, timeout_s: float = GROUP_TIMEOUT_S) -> Ranks:
    """Joins the world of `size` ranks whose rendezvous is the parent's
    store at HOST:`port`: the default group (NCCL for a card, gloo for the
    CPU) and the harness's gloo group."""
    import torch
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(HOST, port, size, False, timeout=timeout)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo", store=store, rank=rank,
                            world_size=size, timeout=timeout,
                            device_id=device if cuda else None)
    ctrl = dist.new_group(backend="gloo", timeout=timeout)
    return Ranks(rank, size, device, dist.group.WORLD, ctrl)


# ------------------------------------------------------- the script's own side
def add_args(ap: argparse.ArgumentParser):
    """The arguments the launcher gives each rank (hidden from --help)."""
    for flag, kind in (("--rank", int), ("--ranks", int), ("--store-port", int),
                       ("--parent", int), ("--started", float), ("--group-timeout", float),
                       ("--device", str), ("--root", str), ("--cache", str)):
        ap.add_argument(flag, type=kind, default=None, help=argparse.SUPPRESS)


def rank_device(args):
    """The torch device of rank `args.rank`: cuda:<rank>, or the CPU."""
    import torch

    return torch.device(f"cuda:{args.rank}") if args.device == "cuda" else torch.device("cpu")


def started_at(wall: float) -> float:
    """The parent's start (`time.time()` there) on this process's
    `time.perf_counter()` clock."""
    return time.perf_counter() - (time.time() - wall)


def emit(payload: dict):
    """Rank 0's result, on its standard output, for the parent."""
    print(RESULT + json.dumps(payload), flush=True)


def _die_with(parent: int):
    """SIGKILL for this process when its parent dies (Linux's
    PR_SET_PDEATHSIG), so no rank outlives a killed run; ends at once if
    the parent is gone already."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def run_rank(body, args) -> int:
    """Runs `body(ranks)` as rank `args.rank` and returns 0.  If it
    raises, the process ends at once with code 1 and the traceback on
    standard error: an interpreter's normal exit could wait on a collective
    that the other ranks never join.  The groups are left without a
    barrier, so a rank that ends early waits for no other."""
    import traceback

    _die_with(args.parent)
    try:
        r = join(args.rank, args.ranks, args.store_port, rank_device(args), args.group_timeout)
        body(r)
        r.close()
        return 0
    except Exception:                    # a rank's failure is the run's: report it, end it
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


# ------------------------------------------------------------ the parent's side
def launch(script: str, argv: list, n: int, device: str, root: str, cache: str,
           t_start: float, log=print, timeout_s: float = GROUP_TIMEOUT_S):
    """Runs `script` `argv` as `n` ranks and waits for them: (exit code,
    rank 0's result payload or None).  The code is 0 once every rank has
    exited with 0; it is 1, and the other ranks are killed, as soon as one
    exits with another code, or when a rank is still running `timeout_s`
    after another has finished (its group would have timed out)."""
    import torch.distributed as dist

    store = dist.TCPStore(HOST, 0, None, True, timeout=datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    wall = time.time() - (time.perf_counter() - t_start)
    procs, readers, got, lock = [], [], {}, threading.Lock()

    def say(line):
        with lock:
            log(line)

    def read(r, stream):
        for line in stream:
            line = line.rstrip("\n")
            if r == 0 and line.startswith(RESULT):
                got["payload"] = json.loads(line[len(RESULT):])
            elif r == 0:
                say(line)
            else:
                say(f"# rank {r}: {line.lstrip('# ')}")

    rc, first_done = 1, None
    try:
        for r in range(n):
            cmd = [sys.executable, script, *argv, "--rank", str(r), "--ranks", str(n),
                   "--store-port", str(store.port), "--parent", str(os.getpid()),
                   "--started", repr(wall),
                   "--group-timeout", repr(timeout_s), "--device", device, "--root", root,
                   "--cache", cache]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stdin=subprocess.DEVNULL,
                                          text=True))
        for r, p in enumerate(procs):
            t = threading.Thread(target=read, args=(r, p.stdout), daemon=True)
            t.start()
            readers.append(t)
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                say("# the run ends: " + ", ".join(f"rank {r} exited with {c}" for r, c in bad))
                break
            if all(c == 0 for c in codes):
                rc = 0
                break
            if first_done is None and 0 in codes:
                first_done = time.monotonic()
            if first_done is not None and time.monotonic() - first_done > timeout_s:
                say(f"# ranks still running {timeout_s:g} s after another finished: the run ends")
                break
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(KILL_WAIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in readers:
            t.join(KILL_WAIT_S)
    return rc, (got.get("payload") if rc == 0 else None)
