"""Train-state checkpoints with the JAX package's policy knobs.

Counterpart of ``arcflow_tpu/runner/checkpoint.py`` (``CheckpointManager``,
``load_raw_checkpoint``, ``resolve_checkpoint_dir``) without Orbax: a
checkpoint is one ``torch.save`` of plain tensors, ints and the optimizers'
``state_dict()``s, in ``<directory>/<step>/state.pt``:

* ``step`` (int), ``trainable`` and ``ema`` ({submodule: {name: tensor}}),
  ``frozen`` unless ``ckpt_trainable_only``, ``optimizers`` ({submodule:
  ``state_dict()``}) and ``generator`` (``torch.Generator.get_state()``);
* it is loaded with ``weights_only=True`` onto the host;
* ``save`` copies every tensor to the host, one at a time (a FLUX-12B
  adapter with its EMA and AdamW slots is about 10 GB, which must not be
  copied twice on the card), then writes on a background thread when
  ``async_save``;
* a write goes to a hidden directory that is renamed to ``<step>`` once
  the file is complete, so a save killed half way leaves nothing that
  ``latest_step`` picks (and the next manager on the directory removes it);
* ``ckpt_fp16`` / ``ckpt_fp16_ema`` / ``ckpt_bf16_optim`` store the
  trainable weights / the EMA / the optimizer slots in fp16 / fp16 / bf16
  (the optimizers' step counts stay as they are); ``restore`` copies every
  tensor back into the live one, in its dtype, and loads the optimizers
  with ``load_state_dict``;
* ``interval``, ``must_save_interval`` (steps kept forever) and
  ``max_keep_ckpts`` (the newest other steps kept) as in JAX.

Paths: a plain directory, ``tmp:name`` under the process's temporary
directory, or a remote URI of ``utils/io_utils`` (``s3://`` ...), staged in
a local directory and mirrored as in JAX: after each save rank 0 pushes the
step's files, ``manifest-<step>.txt`` and ``latest.txt`` (in the writer,
before pruning: ``wait`` returns once the remote holds the step), and a new
manager pulls the latest remote step into its staging directory (one
process per host, the others at a barrier), so a fresh machine resumes
from the remote. The mirror carries the port's format (``state.pt``).

Over several ranks (``torch.distributed``) the format stays the same, so
a checkpoint does not depend on the layout it was written from: every rank
joins the gather of each sharded tensor (a ``DTensor``, ``parallel/
fsdp.py``; the frozen trunk's too, its int8 / int4 kernels included) to
one full tensor, one tensor at a time, which rank 0 copies to the host,
row-major, and writes; ``restore`` loads the full tensors on every rank
and copies each rank's shard into its live tensor. On a model placed on
``pipe`` / ``expert`` axes (``parallel/model_parallel.py``) the holders of
each stage's blocks and each rank's experts send them to rank 0, and a
restore keeps each rank's part; on a model split over ``tensor``
(``parallel/tensor.py:TensorPlacement``) a split tensor's parts are
gathered over its tensor group (each an FSDP2 gather first) and put back
in the one-device layout, and a restore cuts each rank's part, then its
fsdp shard. Rank 0 alone makes,
cleans and prunes the directory; the ranks meet at a barrier before each
save, after the last and before a restore, so they see one directory.
"""

from __future__ import annotations

import copy
import hashlib
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.fsdp import DTensor, is_sharded, local, shard_of
from ..utils.io_utils import (get_file_backend, is_node_local_rank_zero,
                              uri_scheme)
from .train_state import TrainState

STATE_FILE = 'state.pt'
_PARTIAL = '.partial-'


def resolve_checkpoint_dir(uri: str) -> Tuple[str, Optional[str]]:
    """A checkpoint URI -> (its local directory, the remote URI or None), as
    JAX's (``arcflow_tpu/runner/checkpoint.py:25-50``): ``tmp:name`` lies
    under ``tempfile.gettempdir()``; a remote scheme of ``utils/io_utils``
    (``s3://`` ...) is staged under ``arcflow_ckpt_<md5 of the URI>`` there
    and mirrored; a plain path is itself."""
    if uri.startswith('tmp:'):
        return os.path.join(tempfile.gettempdir(), 'arcflow_ckpt',
                            uri[len('tmp:'):]), None
    if uri_scheme(uri) != 'local':
        tag = hashlib.md5(uri.encode()).hexdigest()[:10]
        return os.path.join(tempfile.gettempdir(),
                            f'arcflow_ckpt_{tag}'), uri.rstrip('/')
    return uri, None


def push_step(local_dir: str, remote_uri: str, step: int):
    """Mirror ``local_dir/<step>`` to ``remote_uri/<step>`` file by file
    (``put_file``: streamed, multipart on S3), then ``manifest-<step>.txt``
    (the files' relative paths) and ``latest.txt`` (JAX
    ``_push_step_to_remote``)."""
    be = get_file_backend(remote_uri)
    step_dir = os.path.join(local_dir, str(step))
    manifest = []
    for root, _, files in os.walk(step_dir):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(root, f), step_dir)
            manifest.append(rel)
            be.put_file(os.path.join(step_dir, rel),
                        be.join_path(remote_uri, str(step), rel))
    be.put('\n'.join(manifest).encode(),
           be.join_path(remote_uri, f'manifest-{step}.txt'))
    be.put(str(step).encode(), be.join_path(remote_uri, 'latest.txt'))


def pull_step(local_dir: str, remote_uri: str, step: Optional[int] = None
              ) -> Optional[int]:
    """Fetch ``step`` (by default the one ``latest.txt`` names) from
    ``remote_uri`` into ``local_dir/<step>`` unless it is there already
    (JAX ``_pull_latest_from_remote``); written to a hidden directory and
    renamed, as a save is. Returns the step, or None when the remote holds
    no checkpoint."""
    be = get_file_backend(remote_uri)
    if step is None:
        latest = be.join_path(remote_uri, 'latest.txt')
        if not be.exists(latest):
            return None
        step = int(be.get(latest).decode().strip())
    if os.path.isdir(os.path.join(local_dir, str(step))):
        return step
    manifest = be.get(be.join_path(
        remote_uri, f'manifest-{step}.txt')).decode().splitlines()
    os.makedirs(local_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f'{_PARTIAL}{step}-', dir=local_dir)
    for rel in manifest:
        dst = os.path.join(tmp, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        be.get_file(be.join_path(remote_uri, str(step), rel), dst)
    os.rename(tmp, os.path.join(local_dir, str(step)))
    return step


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier():
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host(dtype: Optional[torch.dtype] = None):
    """Tensor -> a host copy of it (cast first to ``dtype`` when it is a
    float tensor and one is given); other values pass. A sharded tensor is
    gathered first, with every rank taking part; only rank 0 keeps it."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if is_sharded(x):
            x = x.full_tensor()
        if _rank() != 0:
            return None
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        # row-major whatever the live layout (a gathered ``DTensor`` is
        # row-major), so a checkpoint's bytes do not depend on the layout
        # it was written from
        return x.to('cpu', copy=True, memory_format=torch.contiguous_format)
    return leaf


def _host_named(mp, dtype: Optional[torch.dtype] = None):
    """(name, tensor) -> ``_host`` of the one-device tensor ``name`` on a
    model placed on pipe / expert axes (``mp``, a ``ModelParallel``): its
    holders' parts gathered on rank 0."""
    def leaf(name, x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dim() == 0 or mp is None:
            return _host(dtype)(x)
        return _host(dtype)(mp.gather_full(name, x.detach()))
    return leaf


def _param_names(tx: torch.optim.Optimizer, named: Dict[str, torch.Tensor]
                 ) -> list:
    """The names of ``tx``'s parameters in its state dict's order."""
    by_id = {id(p): n for n, p in named.items()}
    return [by_id[id(p)] for g in tx.param_groups for p in g['params']]


def _optimizer_to_host(sd: dict, dtype: Optional[torch.dtype],
                       mp=None, names=None) -> dict:
    """An optimizer ``state_dict`` on the host, its slots in ``dtype`` when
    one is given; the step counts keep their dtype. On a model placed on
    pipe / expert axes (``mp``) each slot is gathered as its parameter
    (``names``: the parameters' names in order)."""
    state = {i: {k: _host_named(mp if k != 'step' else None,
                                None if k == 'step' else dtype)(
                     names[int(i)] if names else None, v)
                 for k, v in s.items()}
             for i, s in sd['state'].items()}
    return dict(state=state,
                param_groups=copy.deepcopy(sd['param_groups']))


def _shard_optimizer_state(sd: dict, tx: torch.optim.Optimizer, mp=None,
                           names=None) -> dict:
    """A saved optimizer ``state_dict`` (full tensors) with each slot of
    a sharded parameter's shape cut to this rank's shard of it, as a
    ``DTensor`` laid out like the parameter; on a model placed on pipe /
    expert axes (``mp``) to this rank's part of it."""
    params = [p for g in tx.param_groups for p in g['params']]
    for i, st in sd['state'].items():
        p = params[int(i)]
        for k, v in st.items():
            if not isinstance(v, torch.Tensor) or v.dim() == 0:
                continue
            if mp is not None:
                v = st[k] = mp.local_part(names[int(i)], v).to(
                    local(p).device)
            if is_sharded(p) and v.shape == p.shape:
                st[k] = DTensor.from_local(
                    shard_of(v, p).to(local(p).device), p.device_mesh,
                    p.placements, run_check=False, shape=p.shape,
                    stride=p.stride())
    return sd


def _list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isfile(
                      os.path.join(directory, d, STATE_FILE)))


def load_raw_checkpoint(directory: str, step: Optional[int] = None) -> dict:
    """The saved dict of ``step`` (the latest by default) under
    ``directory``, on the host, with no live state needed: e.g. a trained
    flow teacher for a distillation run. A remote URI's step is fetched
    into its staging directory first."""
    directory, remote = resolve_checkpoint_dir(directory)
    if remote is not None:
        step = pull_step(directory, remote, step)
    steps = _list_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f'no checkpoint under {directory}')
        step = steps[-1]
    return torch.load(os.path.join(directory, str(step), STATE_FILE),
                      map_location='cpu', weights_only=True)


class CheckpointManager:
    """Saves and restores a ``TrainState``.

    Args:
        directory: checkpoint root (one subdirectory per step).
        interval: save every N steps (N <= 0: only forced saves).
        must_save_interval: steps at multiples of this are kept forever.
        max_keep_ckpts: how many of the newest other steps are kept.
        ckpt_trainable_only: leave ``frozen`` out (the adapter-sized
            checkpoint).
        ckpt_fp16 / ckpt_fp16_ema / ckpt_bf16_optim: the float downcasts.
        async_save: write on a background thread (one write in flight).
    """

    def __init__(self, directory: str, interval: int = 1000,
                 must_save_interval: Optional[int] = None,
                 max_keep_ckpts: Optional[int] = None,
                 ckpt_trainable_only: bool = True, ckpt_fp16: bool = False,
                 ckpt_fp16_ema: bool = False, ckpt_bf16_optim: bool = False,
                 async_save: bool = True):
        local_dir, self.remote_uri = resolve_checkpoint_dir(directory)
        self.directory = os.path.abspath(local_dir)
        if _rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
            for d in os.listdir(self.directory):
                if d.startswith(_PARTIAL):      # a save killed half way
                    shutil.rmtree(os.path.join(self.directory, d),
                                  ignore_errors=True)
        _barrier()
        if self.remote_uri is not None:
            # one process per host fetches the latest remote step into the
            # host's staging directory; the others wait for it
            if is_node_local_rank_zero():
                pull_step(self.directory, self.remote_uri)
            _barrier()
        self.interval = interval
        self.must_save_interval = must_save_interval
        self.max_keep_ckpts = max_keep_ckpts
        self.ckpt_trainable_only = ckpt_trainable_only
        self.ckpt_fp16 = ckpt_fp16
        self.ckpt_fp16_ema = ckpt_fp16_ema
        self.ckpt_bf16_optim = ckpt_bf16_optim
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # bytes, seconds to stage on the host and to write, of the last save
        self.last_save: Dict[str, float] = {}

    # ---- save -----------------------------------------------------------
    def _to_host(self, state: TrainState) -> dict:
        f16 = torch.float16
        mp = getattr(state, 'model_parallel', None)

        def named(tree, dtype=None):
            leaf = _host_named(mp, dtype)
            return {k: {n: leaf(n, t) for n, t in sub.items()}
                    for k, sub in tree.items()}
        tree = dict(
            step=int(state.step),
            trainable=named(state.trainable, f16 if self.ckpt_fp16 else None),
            ema=None if state.ema is None else named(
                state.ema,
                f16 if self.ckpt_fp16 or self.ckpt_fp16_ema else None),
            optimizers={k: _optimizer_to_host(
                tx.state_dict(),
                torch.bfloat16 if self.ckpt_bf16_optim else None, mp,
                _param_names(tx, state.trainable[k]) if mp else None)
                for k, tx in state.optimizers.items()},
            generator=state.generator.get_state())
        if not self.ckpt_trainable_only:
            tree['frozen'] = named(state.frozen)
        return tree

    def _write(self, tree: dict):
        step = tree['step']
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix=f'{_PARTIAL}{step}-',
                               dir=self.directory)
        path = os.path.join(tmp, STATE_FILE)
        torch.save(tree, path)
        nbytes = os.path.getsize(path)
        os.rename(tmp, os.path.join(self.directory, str(step)))
        self.last_save.update(bytes=nbytes,
                              write_s=time.perf_counter() - t0)
        if self.remote_uri is not None:
            t0 = time.perf_counter()
            push_step(self.directory, self.remote_uri, step)
            self.last_save['push_s'] = time.perf_counter() - t0
        self._prune()

    def _write_guarded(self, tree: dict):
        try:
            self._write(tree)
        except Exception as e:           # re-raised by wait()
            self._error = e

    def _prune(self):
        if not self.max_keep_ckpts:
            return
        steps = _list_steps(self.directory)
        must = self.must_save_interval
        for s in steps[:-self.max_keep_ckpts]:
            if not (must and s % must == 0):
                shutil.rmtree(os.path.join(self.directory, str(s)))

    def save(self, state: TrainState, force: bool = False) -> bool:
        """Save ``state`` at its step when the step is on the interval (or
        ``force``) and not saved already; True when it saved."""
        step = int(state.step)
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return False
        self.wait()
        if os.path.isdir(os.path.join(self.directory, str(step))):
            return False
        t0 = time.perf_counter()
        tree = self._to_host(state)
        self.last_save = dict(step=step, stage_s=time.perf_counter() - t0)
        if _rank() != 0:
            return True
        if self.async_save:
            self._thread = threading.Thread(target=self._write_guarded,
                                            args=(tree,), daemon=False)
            self._thread.start()
        else:
            self._write(tree)
        return True

    def wait(self):
        """Join the write in flight (and meet the other ranks); raise its
        error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError('checkpoint write failed') from err

    def close(self):
        self.wait()

    # ---- resume ----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = _list_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Load ``step`` (the latest by default) into ``state``, in place:
        every saved tensor is copied into its live tensor (a downcast one
        back to the live dtype), the optimizers take their state dicts and
        the generator its state; frozen tensors are kept from the live
        state when the checkpoint is trainable-only. Returns ``state``."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f'no checkpoint under {self.directory}')
        t0 = time.perf_counter()
        raw = load_raw_checkpoint(self.directory, step)
        mp = getattr(state, 'model_parallel', None)
        pairs = [(state.trainable, raw['trainable'], 'trainable')]
        if state.ema is not None:
            pairs.append((state.ema, raw['ema'], 'ema'))
        if not self.ckpt_trainable_only and 'frozen' in raw:
            pairs.append((state.frozen, raw['frozen'], 'frozen'))
        with torch.no_grad():
            for live, saved, what in pairs:
                for k, sub in live.items():
                    if set(sub) != set(saved[k]):
                        raise KeyError(f'{what}.{k}: the checkpoint holds '
                                       f'other tensors than the live state')
                    for n, t in sub.items():
                        full = saved[k][n]
                        if mp is not None:
                            full = mp.local_part(n, full)
                        local(t).copy_(shard_of(full, t))
        for k, tx in state.optimizers.items():
            tx.load_state_dict(_shard_optimizer_state(
                raw['optimizers'][k], tx, mp,
                _param_names(tx, state.trainable[k]) if mp else None))
        state.generator.set_state(raw['generator'])
        state.step = int(raw['step'])
        self.last_restore_s = time.perf_counter() - t0
        return state
