"""Worker processes for the port's process-level tests
(``test_torch_distributed.py``, ``test_torch_halo.py``): a pair joined over
gloo on localhost, and a process alone.

A worker script starts with :data:`JOIN`: it joins the group that
torchrun's variables describe (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``; none set for a process alone) and prints
:data:`JOINED`.  It ends its output with one JSON line, its result, and
then runs :data:`LEAVE`: a process that exits while it is still in its
group can abort in gloo's teardown (SIGABRT, "terminate called without an
active exception"), after its result was printed.  No card is visible to
it.

A pair's port comes from binding port 0 and closing the socket, so another
process may take it before rank 0 binds it.  A pair whose rendezvous fails
— a process ends before both have joined, or they have not joined within
:data:`JOIN_TIMEOUT` — is killed and started again on a fresh port, at most
:data:`ATTEMPTS` times in all, so a lost port costs the seconds until a
process ends.  Once both have joined, a failure is the test's.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

from convolutional_codes_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: printed by a worker once it joined its group (or found none to join)
JOINED = "two_process: joined"

#: a worker script's first lines
JOIN = f"""
from convolutional_codes_tpu_torch.parallel.distributed import initialize_from_env
joined = initialize_from_env(verbose=False)
print({JOINED!r}, flush=True)
"""

#: a worker script's last lines: wait for the other rank, then leave the
#: group, so that neither process exits while the other still uses it
LEAVE = """
if joined:
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
"""

#: starts of a pair, the first included
ATTEMPTS = 3
#: seconds a pair has to join: imports and the rendezvous
JOIN_TIMEOUT = 120
#: seconds a worker has in all, from its start
WORKER_TIMEOUT = 300


def free_ports(n: int) -> list:
    """``n`` distinct ports that were free a moment ago: bound together,
    then released."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in distributed.ENV}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", **extra)
    return env


class _Worker:
    """One process of ``cmd``, its output in temporary files."""

    def __init__(self, cmd, env):
        self.out = tempfile.TemporaryFile()
        self.err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(cmd, cwd=REPO, stdout=self.out, stderr=self.err, env=env)
        self.t0 = time.monotonic()

    def text(self, f) -> str:
        """What the worker wrote to ``f`` so far, read at an offset: the
        worker shares the file's position."""
        fd = f.fileno()
        return os.pread(fd, os.fstat(fd).st_size, 0).decode(errors="replace")

    def joined(self) -> bool:
        return JOINED in self.text(self.out)

    def result(self) -> dict:
        """Wait for the worker to end (killed at :data:`WORKER_TIMEOUT`) and
        return its last output line as JSON; a failed worker fails the test
        with its errors."""
        try:
            self.proc.wait(timeout=max(0.0, WORKER_TIMEOUT - (time.monotonic() - self.t0)))
        finally:
            self.proc.kill()
            self.proc.wait()
        out, err = self.close()
        assert self.proc.returncode == 0, err
        return json.loads(out.strip().splitlines()[-1])

    def kill(self) -> str:
        """Kill the worker; its errors."""
        self.proc.kill()
        self.proc.wait()
        return self.close()[1]

    def close(self):
        """The worker's output and errors; the files are closed."""
        texts = self.text(self.out), self.text(self.err)
        self.out.close()
        self.err.close()
        return texts


def alone(script: str, *argv) -> dict:
    """Run ``script`` in one process of its own; its result."""
    return _Worker([sys.executable, "-c", script, *map(str, argv)], _env()).result()


class Pair:
    """``script`` in two processes, ranks 0 and 1 of one gloo group; they
    start here, and :meth:`results` waits for them."""

    def __init__(self, script: str, *argv, port: int = None):
        self.cmd = [sys.executable, "-c", script, *map(str, argv)]
        self.attempts = 0
        self._start(port)

    def _start(self, port):
        port = port or free_ports(1)[0]
        self.attempts += 1
        self.workers = [_Worker(self.cmd, _env(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                                               WORLD_SIZE="2", RANK=str(r)))
                        for r in range(2)]

    def _joined(self) -> bool:
        """Whether both workers join, polled until one ends without having
        joined or :data:`JOIN_TIMEOUT` passes."""
        t0 = self.workers[0].t0
        while time.monotonic() - t0 < JOIN_TIMEOUT:
            if all(w.joined() for w in self.workers):
                return True
            if any(w.proc.poll() is not None and not w.joined() for w in self.workers):
                return False
            time.sleep(0.1)
        return all(w.joined() for w in self.workers)

    def results(self) -> list:
        """Each rank's result, rank 0 first; a pair that fails to join
        starts again on a fresh port, at most :data:`ATTEMPTS` times."""
        while not self._joined():
            errors = [w.kill() for w in self.workers]
            assert self.attempts < ATTEMPTS, (
                f"no rendezvous in {self.attempts} attempts; the last one's errors:\n"
                + "\n".join(errors))
            self._start(None)
        return [w.result() for w in self.workers]
