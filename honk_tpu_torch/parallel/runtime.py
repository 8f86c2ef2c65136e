"""Multi-process runtime on ``torch.distributed`` (counterpart of ``honk_tpu.parallel.runtime``).

One process per device. ``initialize_distributed`` joins the processes
into one process group over TCP (``tcp://<coordinator_address>``): NCCL
when the ranks run on the card, gloo on the CPU. Without a coordinator it
does nothing, and the process is rank 0 of a world of one.

Launch, one process per device:

    python -m honk_tpu_torch.cli.train --coordinator <host0>:<port> \\
        --process-id <i> --num-processes <n> ...

or let ``--n_devices N`` start N local ranks over 127.0.0.1.

A process group that fails to initialise raises: a rank never runs alone
in place of a group it was asked to join. A collective that waits longer
than ``GROUP_TIMEOUT`` for the other ranks fails the group (NCCL's
watchdog, gloo's timeout), where NCCL's default would wait ten minutes.

A rank started by ``launch_local_ranks`` beats: a daemon thread writes a
byte to a pipe the launcher holds every ``HEARTBEAT_S``. The launcher ends
the run when a rank that has not exited stays silent for
``HEARTBEAT_TIMEOUT_S``: a rank that is stopped, or killed while its main
thread is held in the driver (it neither runs nor exits, and waits on
nothing the group's timeout sees), loses every other thread and the beat
with them.
"""

from __future__ import annotations

import datetime
import os
import select
import socket
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

# Longer than any wait of a healthy rank for the others (a rank's first kernel
# build, rank 0's checkpoint write); also the store's timeout.
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
# How long the launcher waits for the ranks it killed to be gone.
EXIT_WAIT_S = 60
_PF_EXITING = 0x4  # the flag of a process that has begun to exit (/proc/<pid>/stat)
HEARTBEAT_S = 1.0
# How long a running rank may stay silent before the launcher ends the run. The
# beat needs only the interpreter lock, which a healthy rank's long waits do not
# hold: nvcc runs as a subprocess, and collectives, the store's waits, kernel
# launches and synchronisations run in C++ without it, while Python loops hand it
# over every 5 ms. It also covers a rank's start (the interpreter, torch's import:
# seconds) before initialize_distributed starts the beat.
HEARTBEAT_TIMEOUT_S = 60.0
_HEARTBEAT_FD = "HONK_TPU_TORCH_HEARTBEAT_FD"  # the write end of a rank's pipe, from the launcher


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Join the process group of ``num_processes`` ranks as rank ``process_id``; no-op without a coordinator.

    ``device`` is the device type the ranks run on: ``cuda`` (NCCL, and this
    rank's card becomes the current device) or ``cpu`` (gloo).
    """
    if coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs --num-processes and --process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not a rank of a world of {num_processes}")
    _start_heartbeat()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank_device("cuda", process_id))
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=GROUP_TIMEOUT,
    )


def _start_heartbeat() -> None:
    """Beat on the launcher's pipe, if ``launch_local_ranks`` started this process, until it is gone."""
    fd = os.environ.pop(_HEARTBEAT_FD, None)  # popped: no process this one starts inherits it
    if fd is None:
        return

    def beat(fd: int) -> None:
        try:
            while True:
                os.write(fd, b".")
                time.sleep(HEARTBEAT_S)
        except OSError:  # the launcher closed its end
            pass

    threading.Thread(target=beat, args=(int(fd),), name="rank-heartbeat", daemon=True).start()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that prints, logs and writes checkpoints (rank 0)."""
    return rank() == 0


def rank_device(device: str | torch.device, process_id: int | None = None) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` on the card, ``cpu`` otherwise.

    The local rank is the rank modulo the visible cards, one process per
    card on each host.
    """
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    r = rank() if process_id is None else process_id
    return torch.device("cuda", r % torch.cuda.device_count())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exit_status(pid: int) -> int | None:
    """The status (waitpid's form) of a process that has begun to exit, None while it runs.

    Linux sets it as the process starts to exit, where ``waitpid`` reports
    the process only once it has finished exiting, which a CUDA process
    can take long to do.
    """
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[49]) if int(fields[6]) & _PF_EXITING else None
    except (OSError, IndexError, ValueError):  # gone, or a kernel without the field
        return None


def launch_local_ranks(module: str, argv: list[str], n: int) -> int:
    """Run ``python -m <module> <argv>`` as ``n`` ranks over 127.0.0.1 and wait for them all.

    Each rank is a child process with the same arguments plus
    ``--coordinator``, ``--num-processes`` and its own ``--process-id``; their
    output goes to this process's. If one fails, begins to exit with a
    non-zero status, or stays silent on its heartbeat pipe for
    HEARTBEAT_TIMEOUT_S while it has not exited, the others are killed (they
    would wait in a collective for it), and the launcher waits up to
    EXIT_WAIT_S for them all. Returns the first non-zero exit code (1 for a
    rank still exiting), or 0.
    """
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    # Local ranks share this host's cores: PyTorch's OpenMP workers spin, and
    # N ranks of all-core pools starve each other in every collective.
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    coord = f"127.0.0.1:{_free_port()}"
    procs, beats = [], {}  # beats: the read end of each rank's pipe -> the rank
    try:
        for i in range(n):
            r, w = os.pipe()
            beats[r] = i
            try:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *argv, "--coordinator", coord, "--num-processes", str(n),
                     "--process-id", str(i)], env={**env, _HEARTBEAT_FD: str(w)}, pass_fds=(w,)))
            finally:
                os.close(w)
        last = [time.monotonic()] * n
        open_ends = list(beats)
        failed = False
        while not failed and any(proc.poll() is None for proc in procs):
            ready, _, _ = select.select(open_ends, [], [], 0.1)
            now = time.monotonic()
            for r in ready:
                if os.read(r, 4096):
                    last[beats[r]] = now
                else:  # every writer gone: the rank has exited, or will be seen silent
                    open_ends.remove(r)
            failed = any(proc.returncode or (proc.returncode is None and _exit_status(proc.pid))
                         for proc in procs)
            for i, proc in enumerate(procs):
                if not failed and proc.poll() is None and now - last[i] > HEARTBEAT_TIMEOUT_S:
                    print(f"launch_local_ranks: rank {i} (process {proc.pid}) has not beaten for "
                          f"{now - last[i]:.1f} s and has not exited: ending the run", file=sys.stderr, flush=True)
                    failed = True
    finally:
        for proc in procs:  # exact child PIDs only
            if proc.poll() is None:
                proc.kill()
        deadline = time.monotonic() + EXIT_WAIT_S
        for proc in procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                print(f"launch_local_ranks: rank process {proc.pid} had not exited {EXIT_WAIT_S} s after it was "
                      "killed", file=sys.stderr)
        for r in beats:
            os.close(r)
    return next((proc.returncode for proc in procs if proc.returncode), 1 if failed else 0)
