"""Process-group bootstrap and the gang launcher.

Counterpart of ``apex_tpu/parallel/multiproc.py`` (itself the shim for
``python -m apex.parallel.multiproc``).  In JAX a data-parallel step is
one SPMD program over a mesh axis; in the port each process holds one
replica and its own shard of the batch, joined by a ``torch.distributed``
process group.

============================================  ================================
JAX package                                   port
============================================  ================================
``init_distributed`` -> ``jax.distributed.``  :func:`init_distributed` ->
  ``initialize`` (coordinator address, env)     ``dist.init_process_group``
``dist_init_timeout_s`` (reads an env var)    ``timeout_s=`` (an argument)
``launch`` (gang spawn, stderr tails)         :func:`launch`, the same
``WorkerResult``, ``MultiprocError``,         the same
  ``guilty_ranks()``, ``TEARDOWN_RC``
``python -m apex_tpu.parallel.multiproc``     ``python -m apex_tpu_torch.``
                                                ``parallel.multiproc``
============================================  ================================

The backend is NCCL, for tensors on the card, unless the caller names
another: gloo is taken only when asked for (the CPU tests, and two
processes sharing one card, which NCCL refuses).  Nothing falls back to
gloo on its own.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "MultiprocError",
    "TEARDOWN_RC",
    "WorkerResult",
    "free_port",
    "init_distributed",
    "launch",
    "main",
]

DEFAULT_STDERR_TAIL = 2000  # bytes of worker stderr quoted in errors
DEFAULT_TIMEOUT_S = 300.0   # torch's own default for a process group

#: the exit code of a worker the launcher killed during gang teardown
#: (``p.kill()`` = SIGKILL): a bystander of a peer's death, never a rank
#: that failed on its own
TEARDOWN_RC = -int(signal.SIGKILL)


def init_distributed(backend: str = "nccl", init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Initialise the default process group; returns True if it did.

    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE``
    from the environment; with neither (a plain single-process run) this
    does nothing and returns False, as the JAX version does.  Under
    ``init_method="env://"`` torch reads ``MASTER_ADDR`` and
    ``MASTER_PORT`` (what :func:`launch` sets).  Under NCCL each process
    takes the card ``rank % device_count``."""
    env_rank, env_world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    rank = int(env_rank) if rank is None and env_rank is not None else rank
    if world_size is None and env_world is not None:
        world_size = int(env_world)
    if rank is None and world_size is None:
        return False
    if rank is None or world_size is None:
        raise ValueError(f"init_distributed needs both rank and world_size "
                         f"(got rank={rank}, world_size={world_size})")
    if dist.is_initialized():
        raise RuntimeError("the default process group is already "
                           "initialised")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA device; pass "
                               "backend='gloo' to run on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


class MultiprocError(RuntimeError):
    """A gang failed or timed out; the message carries every failing
    rank's stderr tail."""

    def __init__(self, message: str, results: List["WorkerResult"]):
        super().__init__(message)
        self.results = results

    def guilty_ranks(self) -> List[int]:
        """Ranks that died of their own exit: nonzero and not the
        teardown SIGKILL the launcher deals the rest of the gang.  A
        timed-out gang (everyone torn down) has no guilty rank."""
        return [r.rank for r in self.results
                if r.returncode not in (0, None, TEARDOWN_RC)]


@dataclasses.dataclass
class WorkerResult:
    """One gang member's outcome: exit code (None: killed on teardown
    before it exited), its stderr tail, and its wall time from spawn to
    reap."""

    rank: int
    returncode: Optional[int]
    stderr_tail: str = ""
    wall_s: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.returncode == 0


def _tail(path: str, nbytes: int = DEFAULT_STDERR_TAIL) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - nbytes))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(
    argv: Sequence[str],
    world_size: int = 2,
    *,
    env: Optional[Dict[str, str]] = None,
    timeout_s: Optional[float] = None,
    master_port: Optional[int] = None,
    echo_stderr: bool = True,
    check: bool = False,
) -> List[WorkerResult]:
    """Spawn ``world_size`` copies of ``python argv...`` as one gang.

    Each worker gets ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
    ``RANK`` (what :func:`init_distributed` reads) and its stderr
    captured to a temporary file.  ``MASTER_PORT`` is ``master_port``,
    else the environment's, else a free port.  The gang is reaped as a
    unit: the first nonzero exit, or ``timeout_s`` expiring (the
    survivors blocked in a collective after a peer died), kills the
    rest.  Returns the per-rank :class:`WorkerResult`; with
    ``check=True`` a failed or timed-out gang raises
    :class:`MultiprocError` quoting the failing ranks' stderr tails.
    ``echo_stderr`` replays every worker's stderr tail to this process's
    stderr at the end."""
    argv = list(argv)
    base_env = dict(os.environ if env is None else env)
    port = (master_port if master_port is not None
            else base_env.get("MASTER_PORT") or free_port())
    procs: List[subprocess.Popen] = []
    logs: List[str] = []
    spawned: List[float] = []
    reaped: Dict[int, float] = {}
    timed_out = False
    try:
        for rank in range(world_size):
            wenv = dict(base_env, MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port), WORLD_SIZE=str(world_size),
                        RANK=str(rank))
            fd, log = tempfile.mkstemp(prefix=f"apex_gang_r{rank}_",
                                       suffix=".stderr")
            logs.append(log)
            with os.fdopen(fd, "wb") as stderr:  # the child keeps its own
                spawned.append(time.time())
                procs.append(subprocess.Popen([sys.executable] + argv,
                                              env=wenv, stderr=stderr))
        deadline = None if timeout_s is None else time.time() + timeout_s
        pending = set(range(world_size))
        failed = False
        while pending and not failed:
            for rank in sorted(pending):
                rc = procs[rank].poll()
                if rc is not None:
                    pending.discard(rank)
                    reaped[rank] = time.time()
                    failed = failed or rc != 0
            if failed or not pending:
                break  # one death dooms the rest: reaped below
            if deadline is not None and time.time() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for rank, p in enumerate(procs):  # gang teardown
            if p.poll() is None:
                p.kill()
                reaped.setdefault(rank, time.time())
        for p in procs:
            p.wait()
        t_end = time.time()
        results = [
            WorkerResult(rank=r,
                         returncode=procs[r].returncode
                         if r < len(procs) else None,
                         stderr_tail=_tail(logs[r]) if r < len(logs) else "",
                         wall_s=reaped.get(r, t_end) - spawned[r]
                         if r < len(spawned) else None)
            for r in range(world_size)]
        for log in logs:
            try:
                os.unlink(log)
            except OSError:
                pass
    if echo_stderr:
        for res in results:
            if res.stderr_tail:
                sys.stderr.write(res.stderr_tail)
        sys.stderr.flush()
    bad = [r for r in results if not r.ok]
    if check and (bad or timed_out):
        what = (f"gang timed out after {timeout_s}s" if timed_out
                else "gang failed")
        detail = "\n".join(
            f"--- rank {r.rank} (rc={r.returncode}) stderr tail ---\n"
            f"{r.stderr_tail.strip() or '(empty)'}"
            for r in bad or results)
        raise MultiprocError(f"{what} (world_size={world_size}, "
                             f"argv={argv!r}):\n{detail}", results)
    return results


def main(argv=None) -> int:
    """``python -m apex_tpu_torch.parallel.multiproc script.py [args]``
    (or ``-m module [args]``): ``WORLD_SIZE`` copies (default 2) as one
    gang; the exit code is the first failing rank's."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m apex_tpu_torch.parallel.multiproc "
              "script.py [args...]  (WORLD_SIZE copies, default 2)")
        return 2
    world_size = int(os.environ.get("WORLD_SIZE", "2"))
    rc = 0
    for r in launch(argv, world_size):
        rc = rc or (r.returncode or 0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
