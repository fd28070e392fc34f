"""Start ``n`` ranks of one program on this machine.

``spawn(fn, n, args)`` runs ``fn(*args)`` in ``n`` fresh processes
(``torch.multiprocessing``, spawn start method) with the variables
``mesh.setup_distributed`` reads, a free local port for the rendezvous, and
a bound on the time it waits: past it the ranks are killed and it raises,
so a hung collective cannot hang the caller. ``fn`` must be importable (a
module-level function).
"""

from __future__ import annotations

import os
import socket
import time

import torch.multiprocessing as mp


def _free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _run_rank(rank, fn, args, nprocs, port):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nprocs), MASTER_ADDR='localhost',
                      MASTER_PORT=str(port))
    fn(*args)


def spawn(fn, nprocs: int, args: tuple = (), timeout: float = 600.0) -> None:
    """Run ``fn(*args)`` on ranks 0 .. nprocs-1 and wait for all of them.
    Raises if a rank fails (the others are stopped) or if they are not all
    done within ``timeout`` seconds (all are killed)."""
    ctx = mp.start_processes(
        _run_rank, args=(fn, args, nprocs, _free_port()), nprocs=nprocs,
        join=False, start_method='spawn')
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f'{nprocs} ranks not done after '
                                   f'{timeout:.0f} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
