"""Preemption-safe training with the port's CLI: SIGTERM mid-run flushes a
checkpoint at the exact iteration and exits 0; a relaunch resumes there,
and N straight iterations equal k iterations, SIGTERM, relaunch and N - k
more, bitwise (trainable weights, EMA, optimizer state, step and the
generator's state).

Runs ``python -m arcflow_tpu_torch.train --device cpu`` in subprocesses
(the signal handlers install only on a process's main thread), each launch
bounded by a 60 s timeout, on the reduced checkerboard flow config with one
intra-op thread so the two runs' sums are ordered alike.
"""

import os
import signal
import subprocess
import sys
import time

import torch

from arcflow_tpu_torch.runner import load_raw_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1500
TIMEOUT = 60


def _launch(work_dir, total_iters):
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    return subprocess.Popen(
        [sys.executable, '-m', 'arcflow_tpu_torch.train',
         'configs/toy/checkerboard_flow.py', '--device', 'cpu',
         '--work-dir', work_dir, '--cfg-options',
         f'total_iters={total_iters}', 'checkpoint_config.interval=1000000',
         'log_config.interval=10',
         'model.diffusion.denoising.hidden=(64,64)',
         'data.train_dataloader.samples_per_gpu=64'],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(proc):
    try:
        out, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    return out


def _ckpt(work_dir):
    return os.path.join(work_dir, 'checkpoints', 'checkerboard_flow')


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}{k}.'))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix[:-1]: tree}


def test_sigterm_flushes_and_the_resume_is_bitwise_lossless(tmp_path):
    straight, split = str(tmp_path / 'straight'), str(tmp_path / 'split')
    _finish(_launch(straight, N))

    proc = _launch(split, 1000000)
    lines, t0 = [], time.time()
    try:
        while time.time() - t0 < TIMEOUT:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if 'iter [' in line:
                break
        assert any('iter [' in x for x in lines), ''.join(lines[-30:])
        proc.send_signal(signal.SIGTERM)
        out = ''.join(lines) + _finish(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert 'preempted at iter' in out, out[-3000:]
    k = int(out.split('preempted at iter ')[1].split(';')[0])
    assert 10 <= k < N
    steps = sorted(int(d) for d in os.listdir(_ckpt(split)) if d.isdigit())
    assert steps == [k], steps               # not on the 1e6 interval

    out2 = _finish(_launch(split, N))
    assert f'resumed from iter {k}' in out2, out2[-3000:]
    a, b = load_raw_checkpoint(_ckpt(straight)), \
        load_raw_checkpoint(_ckpt(split))
    assert a['step'] == b['step'] == N
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for key, x in fa.items():
        if isinstance(x, torch.Tensor):
            assert x.dtype == fb[key].dtype and torch.equal(x, fb[key]), key
        else:
            assert x == fb[key], key
