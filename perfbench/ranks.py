"""The ranks of a cell on several cards: one process per card, each a rank
of the program's data-parallel path (``parallel/mesh.py``).

Rank 0 is the harness's process. After it has built the kernel library,
its set-up starts ranks 1..N-1 (:class:`Ranks`), each on
``cuda:<rank>``, with the launch variables ``mesh.launch_env`` reads
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``
on a free port); every rank then joins the group with
``mesh.init_process_group`` (:func:`join_group`). Rank 0 decides each call:
before each of its own calls it writes one byte to every rank's standard
input ("one more"), and at the end another ("stop"), so the timed stream
holds no device work of the benchmark's own. A rank answers "stop" with
one JSON line on its standard output (its peak device memory and its
calls) and leaves the group.

A fault ends the run instead of hanging it. A rank that exits before it is
told to stop, a failed init, or a collective that never completes makes
rank 0 kill every rank and exit with code 4 within ``POLL_S`` of the exit,
or ``STALL_S`` after its last progress (a call issued, a stage of set-up),
whichever comes; the process group's own timeout is ``PG_TIMEOUT_S``. A
rank exits within ``POLL_S`` once rank 0 is gone, and on an end of its
input. So a run whose rank hangs ends, non-zero and with no result, at
most ``STALL_S + POLL_S`` seconds after its last progress.

A rank process (rank 0 starts it; no one else needs to)::

    python3 -m perfbench.ranks --workload <name> --seed <n> --rank <r> --device <dev>
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parent.parent
LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
#: the process group's timeout: its rendezvous and each collective
PG_TIMEOUT_S = 90
#: rank 0 ends the run after this long without progress while ranks run
STALL_S = 120
#: how often the watchdogs look
POLL_S = 0.5
#: how long rank 0 waits for the ranks' answers to "stop"
STOP_S = 60
#: the rank process; the arguments follow
COMMAND = [sys.executable, "-m", "perfbench.ranks"]
ONE_MORE, STOP = b"c", b"s"
FAILED = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_vars(rank: int, world: int, port: int) -> dict:
    return {"WORLD_SIZE": str(world), "RANK": str(rank), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def rank_device(device, rank: int) -> str:
    """Rank ``rank``'s device: its own card, or the CPU where rank 0 runs there."""
    import torch

    device = torch.device(device)
    return f"cuda:{rank}" if device.type == "cuda" else "cpu"


def join_group(device, env: Optional[dict] = None):
    """Joins the process group from the launch variables (``env``: set in
    this process while it joins, then restored) with the program's
    ``mesh.init_process_group``; returns the program's ``DataParallel``."""
    import torch.distributed.distributed_c10d as c10d

    from probunet_torch.parallel import mesh

    # the default timeout of the group (rendezvous and collectives), NCCL's and gloo's
    c10d.default_pg_timeout = c10d.default_pg_nccl_timeout = timedelta(seconds=PG_TIMEOUT_S)
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        mesh.init_process_group(mesh.launch_env(), device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return mesh.DataParallel()


def leave_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class Ranks:
    """Ranks 1..N-1 of a cell, as seen from rank 0: started on creation,
    told each call (:meth:`tell`), stopped (:meth:`stop`) and waited for
    (:meth:`join`), and watched until then (the module docstring)."""

    def __init__(self, cell, seed: int, device):
        self.world = cell.chips
        self.port = free_port()
        self.stall_s = STALL_S
        self.told = 0
        self.stopping = False
        self.last = time.monotonic()
        self.done = False
        self.lines: List[List[str]] = []
        self.procs: List[subprocess.Popen] = []
        self.drains: List[threading.Thread] = []
        env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
        overrides = json.dumps(cell.overrides or {})
        atexit.register(self.kill)
        for r in range(1, self.world):
            args = ["--workload", cell.name, "--seed", str(seed), "--rank", str(r),
                    "--device", rank_device(device, r), "--overrides", overrides]
            p = subprocess.Popen(COMMAND + args, cwd=ROOT, stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, env={**env, **self.env(r)})
            self.procs.append(p)
            self.lines.append([])
            self.drains.append(threading.Thread(target=self._drain, args=(p, self.lines[-1]),
                                                daemon=True))
            self.drains[-1].start()
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    def env(self, rank: int) -> dict:
        return launch_vars(rank, self.world, self.port)

    def beat(self) -> None:
        """Progress: the stall watchdog counts from here."""
        self.last = time.monotonic()

    def tell(self) -> None:
        """One more call, to every rank."""
        self.beat()
        self.told += 1
        for r, p in enumerate(self.procs, 1):
            try:
                p.stdin.write(ONE_MORE)
                p.stdin.flush()
            except OSError as e:
                raise RuntimeError(f"rank {r} is gone (exit code {p.poll()})") from e

    def stop(self) -> List[dict]:
        """Tells every rank to stop and returns their answers (rank 1 on);
        raises where one exits without its answer or gives none within
        ``STOP_S``."""
        self.beat()
        self.stopping = True
        for p in self.procs:
            p.stdin.write(STOP)
            p.stdin.flush()
        deadline = time.monotonic() + STOP_S
        answers = []
        for r, (p, drain) in enumerate(zip(self.procs, self.drains), 1):
            while self._answer(r) is None and p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            drain.join(timeout=0 if p.poll() is None else 5)   # an exited rank's last line
            if self._answer(r) is None:
                raise RuntimeError(f"rank {r} gave no answer to stop (exit code {p.poll()})")
            answers.append(self._answer(r))
        return answers

    def _answer(self, rank: int) -> Optional[dict]:
        return next((json.loads(s) for s in reversed(self.lines[rank - 1]) if s.startswith("{")),
                    None)

    def join(self) -> None:
        """Waits for every rank to end (killing one still there after
        ``STOP_S``); raises if one ended with another code than 0."""
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=STOP_S))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        self.done = True   # the watchdog stops
        bad = {r: c for r, c in enumerate(codes, 1) if c}
        if bad:
            raise RuntimeError(f"ranks ended with exit codes {bad}")

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    # ---- watching ----------------------------------------------------------------------
    def _drain(self, p: subprocess.Popen, lines: List[str]) -> None:
        for raw in p.stdout:
            lines.append(raw.decode(errors="replace").strip())

    def _fail(self, why: str) -> None:
        log(f"ranks: {why}; killing every rank and ending the run")
        self.kill()
        os._exit(FAILED)

    def _watchdog(self) -> None:
        while not self.done:
            time.sleep(POLL_S)
            for r, p in enumerate(self.procs, 1):
                if p.poll() is not None and not self.stopping:
                    self._fail(f"rank {r} exited with code {p.returncode} before it was stopped")
            idle = time.monotonic() - self.last
            if idle > self.stall_s and not self.done:
                self._fail(f"no progress for {idle:.0f} s (a rank or a collective hangs)")


# ---- a rank's process ------------------------------------------------------------------

def _orphan_watch(parent: int) -> None:
    """Ends this rank within ``POLL_S`` once rank 0 is gone."""
    while True:
        time.sleep(POLL_S)
        if os.getppid() != parent:
            os._exit(FAILED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a cell on several cards")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--overrides", default="{}")
    args = ap.parse_args(argv)
    threading.Thread(target=_orphan_watch, args=(os.getppid(),), daemon=True).start()

    import torch

    from perfbench import harness

    torch.set_num_threads(2)
    cell = harness.Cell(args.workload, overrides=json.loads(args.overrides) or None)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)   # this rank's card only: no context on another
    job = cell.family().make_job(cell, args.seed, device, rank=args.rank)
    job.build_kernels()
    job.setup()
    commands = sys.stdin.buffer
    while True:
        cmd = commands.read(1)
        if cmd == ONE_MORE:
            job.call()
        elif cmd == STOP:
            break
        else:
            log(f"rank {args.rank}: the channel from rank 0 closed")
            return FAILED
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(json.dumps({"rank": args.rank, "calls": job.k, "peak_bytes": peak}), flush=True)
    leave_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
