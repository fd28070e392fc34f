"""Start ``n`` ranks of one program on this machine.

``spawn(fn, n, args)`` runs ``fn(*args)`` in ``n`` fresh processes
(``torch.multiprocessing``, spawn start method) with the variables
``mesh.setup_distributed`` reads, a free local port for the rendezvous, and
a bound on the time it waits: past it the ranks are killed and it raises,
so a hung collective cannot hang the caller. ``fn`` must be importable (a
module-level function). ``apply_dist_params`` reads a config's
``dist_params`` (JAX's keys) into the variables ``setup_distributed``
reads.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Optional

import torch.multiprocessing as mp


def apply_dist_params(dist_params: Optional[dict]) -> int:
    """Set the ``torch.distributed`` variables from a config's
    ``dist_params`` as JAX reads them (``arcflow_tpu/parallel/mesh.py:
    31-58``): ``num_processes`` -> ``WORLD_SIZE``, ``process_id`` ->
    ``RANK``, ``coordinator_address`` 'host:port' -> ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``local_device_ids`` (one id: one card per process)
    -> ``LOCAL_RANK``. A key the config leaves out keeps what the launcher
    (``torch.distributed.run``, ``spawn``) set. Returns the world size."""
    cfg = dict(dist_params or {})
    env = {}
    if cfg.get('num_processes') is not None:
        env['WORLD_SIZE'] = cfg['num_processes']
    if cfg.get('process_id') is not None:
        env['RANK'] = cfg['process_id']
    if cfg.get('coordinator_address'):
        host, _, port = str(cfg['coordinator_address']).rpartition(':')
        env.update(MASTER_ADDR=host, MASTER_PORT=port)
    ids = cfg.get('local_device_ids')
    if ids is not None:
        ids = [ids] if isinstance(ids, int) else list(ids)
        if len(ids) != 1:
            raise ValueError(f'local_device_ids {ids}: the port runs one '
                             f'card per process')
        env['LOCAL_RANK'] = ids[0]
    os.environ.update({k: str(v) for k, v in env.items()})
    return int(os.environ.get('WORLD_SIZE', 1))


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
