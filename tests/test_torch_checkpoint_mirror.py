"""The port's remote checkpoint mirror (``runner/checkpoint.py``) against
the JAX package's (``tests/test_checkpoint_uri.py``), with remote storage
faked on ``tmp_path`` by a backend instance registered in the port's
``utils/io_utils`` for the test and taken out again with ``_BACKENDS.pop``.

Both managers mirror each save as ``<uri>/<step>/<files>``,
``manifest-<step>.txt`` and ``latest.txt``, and a manager on an empty
staging directory (a fresh machine) pulls the latest step back. The port's
files are its own format (``state.pt``); JAX's Orbax's. A fresh restore
must give the saved state bit for bit (the next step too), as a local one
does (``tests/test_torch_checkpoint.py``).
"""

import io
import os
import sys
import types

import numpy as np
import pytest
import torch

from arcflow_tpu_torch.runner import CheckpointManager, load_raw_checkpoint
from arcflow_tpu_torch.runner import checkpoint as ckpt
from arcflow_tpu_torch.utils import io_utils
from test_torch_checkpoint import assert_bitwise, make, run
from test_torch_io_utils import BytesBackend

torch.set_num_threads(1)

URI = 's3://ckpts/job1'


@pytest.fixture
def bucket(tmp_path, monkeypatch):
    """A fake S3 under tmp_path/bucket, and a staging directory per
    'machine' (``stage``), as ``tests/test_checkpoint_uri.py`` stages."""
    be = BytesBackend(tmp_path / 'bucket')
    io_utils.register_backend('s3', be)
    machine = dict(stage='stage1')
    real = ckpt.resolve_checkpoint_dir

    def resolve(uri):
        if uri.startswith('s3://'):
            return str(tmp_path / machine['stage']), uri.rstrip('/')
        return real(uri)
    monkeypatch.setattr(ckpt, 'resolve_checkpoint_dir', resolve)
    yield be, machine
    io_utils._BACKENDS.pop('s3', None)


def test_resolve_checkpoint_dir_schemes_as_jax(tmp_path):
    from arcflow_tpu.runner.checkpoint import \
        resolve_checkpoint_dir as j_resolve
    assert ckpt.resolve_checkpoint_dir(str(tmp_path / 'ck')) == \
        j_resolve(str(tmp_path / 'ck')) == (str(tmp_path / 'ck'), None)
    local, remote = ckpt.resolve_checkpoint_dir('s3://bucket/prefix/')
    j_local, j_remote = j_resolve('s3://bucket/prefix/')
    assert remote == j_remote == 's3://bucket/prefix'
    # the same md5 tag, under the temporary directory (JAX: /dev/shm)
    assert os.path.isabs(local) and \
        os.path.basename(local) == os.path.basename(j_local)


def test_s3_mirror_save_and_fresh_restore(tmp_path, bucket):
    """JAX's test of the same name, on the port's format: save at step 10,
    the files land in the bucket; a fresh machine restores step 10."""
    _, machine = bucket
    _, _, state, step = make()
    state = run(state, step, 10)
    assert state.step == 10
    mgr = CheckpointManager(URI, interval=10)
    assert mgr.save(state)
    mgr.close()
    root = tmp_path / 'bucket' / 'ckpts' / 'job1'
    assert (root / 'latest.txt').read_text() == '10'
    assert (root / 'manifest-10.txt').read_text() == 'state.pt'
    assert (root / '10' / 'state.pt').read_bytes() == \
        (tmp_path / 'stage1' / '10' / 'state.pt').read_bytes()
    assert mgr.last_save['push_s'] >= 0

    machine['stage'] = 'stage2'
    _, _, fresh, step2 = make(seed=7)
    mgr2 = CheckpointManager(URI, interval=10)
    assert mgr2.latest_step() == 10
    mgr2.restore(fresh)
    mgr2.close()
    assert_bitwise(fresh, state)
    a, b = run(state, step, 1, seed=3), run(fresh, step2, 1, seed=3)
    assert_bitwise(a, b)


def test_wiped_locally_the_latest_of_several_steps_comes_back(tmp_path,
                                                              bucket):
    """Saves at 2, 4 and 6 (the manager keeps two locally), the staging
    directory wiped, then a fresh restore and a raw load of the remote
    pull step 6; a raw load of an older step fetches that step."""
    import shutil
    _, machine = bucket
    _, _, state, step = make()
    mgr = CheckpointManager(URI, interval=2, max_keep_ckpts=2,
                            async_save=True)
    saved = {}
    for _ in range(3):
        state = run(state, step, 2, seed=state.step)
        assert mgr.save(state)
        mgr.wait()
        saved[state.step] = load_raw_checkpoint(
            str(tmp_path / 'stage1'), state.step)
    mgr.close()
    assert sorted(os.listdir(tmp_path / 'stage1')) == ['4', '6']
    remote = tmp_path / 'bucket' / 'ckpts' / 'job1'
    assert sorted(d for d in os.listdir(remote) if d.isdigit()) == \
        ['2', '4', '6']
    shutil.rmtree(tmp_path / 'stage1')

    _, _, fresh, _ = make(seed=9)
    mgr2 = CheckpointManager(URI, interval=2)
    assert os.listdir(tmp_path / 'stage1') == ['6']
    mgr2.restore(fresh)
    assert_bitwise(fresh, state)
    raw = load_raw_checkpoint(URI)
    assert raw['step'] == 6
    old = load_raw_checkpoint(URI, step=2)
    for k, t in saved[2]['trainable']['diffusion'].items():
        assert torch.equal(old['trainable']['diffusion'][k], t), k
    assert sorted(os.listdir(tmp_path / 'stage1')) == ['2', '6']


def test_no_remote_checkpoint_starts_empty(tmp_path, bucket):
    mgr = CheckpointManager(URI, interval=5)
    assert mgr.latest_step() is None
    assert not os.path.exists(tmp_path / 'bucket' / 'ckpts')
    with pytest.raises(FileNotFoundError):
        load_raw_checkpoint(URI)


def test_only_the_node_local_rank_zero_pulls(tmp_path, bucket,
                                             monkeypatch):
    """A second process on the host (LOCAL_RANK 1) leaves the pull to local
    rank 0 (here: nothing staged, so it finds no step)."""
    _, machine = bucket
    _, _, state, step = make()
    state = run(state, step, 3)
    mgr = CheckpointManager(URI, interval=3, async_save=False)
    mgr.save(state)
    machine['stage'] = 'other'
    monkeypatch.setenv('LOCAL_RANK', '1')
    assert CheckpointManager(URI).latest_step() is None
    monkeypatch.setenv('LOCAL_RANK', '0')
    assert CheckpointManager(URI).latest_step() == 3
    assert np.array_equal(
        os.listdir(tmp_path / 'other'), ['3'])


def test_checkpoint_files_are_streamed_not_put_as_one_body(tmp_path,
                                                          bucket):
    """The mirror sends each checkpoint file with ``put_file`` (streamed;
    multipart on S3), never as one ``put`` body: a remote that refuses a
    body over a limit (S3: 5 GB for one PUT, where the shipped FLUX
    config's trainable-only ``state.pt`` is about 10 GB) still takes it,
    and only the manifest and ``latest.txt`` go through ``put``."""
    be, machine = bucket
    be.limit = 1024
    _, _, state, step = make()
    state = run(state, step, 2)
    mgr = CheckpointManager(URI, interval=2)
    assert mgr.save(state)
    mgr.close()
    assert os.path.getsize(tmp_path / 'stage1' / '2' / 'state.pt') > be.limit
    assert sorted(be.puts) == [URI + '/latest.txt', URI + '/manifest-2.txt']
    machine['stage'] = 'stage2'
    _, _, fresh, _ = make(seed=5)
    CheckpointManager(URI).restore(fresh)
    assert_bitwise(fresh, state)


class FakeS3Client:
    """boto3's S3 client on the disk under ``root``: ``put_object`` refuses
    a body over ``limit`` bytes, as S3 refuses one PUT over 5 GB; the
    managed ``upload_file`` / ``download_file`` move a file in parts of at
    most ``limit`` bytes."""

    def __init__(self, root, limit):
        self.root, self.limit, self.calls = str(root), limit, []

    def _path(self, bucket, key):
        return os.path.join(self.root, bucket, key)

    def put_object(self, Bucket, Key, Body):
        if len(Body) > self.limit:
            raise ValueError(f'EntityTooLarge: {len(Body)} bytes')
        self.calls.append(('put_object', Key))
        os.makedirs(os.path.dirname(self._path(Bucket, Key)), exist_ok=True)
        with open(self._path(Bucket, Key), 'wb') as f:
            f.write(Body)

    def get_object(self, Bucket, Key):
        with open(self._path(Bucket, Key), 'rb') as f:
            return {'Body': io.BytesIO(f.read())}

    def head_object(self, Bucket, Key):
        if not os.path.exists(self._path(Bucket, Key)):
            raise FileNotFoundError(Key)

    def _copy(self, src, dst, name, key):
        parts = 0
        with open(src, 'rb') as fs, open(dst, 'wb') as fd:
            while chunk := fs.read(self.limit):
                fd.write(chunk)
                parts += 1
        self.calls.append((name, key, parts))

    def upload_file(self, Filename, Bucket, Key):
        os.makedirs(os.path.dirname(self._path(Bucket, Key)), exist_ok=True)
        self._copy(Filename, self._path(Bucket, Key), 'upload_file', Key)

    def download_file(self, Bucket, Key, Filename):
        self._copy(self._path(Bucket, Key), Filename, 'download_file', Key)


def test_s3_backend_mirrors_a_file_over_one_put_limit(tmp_path,
                                                      monkeypatch):
    """The port's own ``S3Backend`` (boto3 faked on the disk) mirrors a
    ``state.pt`` larger than one PUT may be through boto3's managed
    transfers, in several parts each way, and a fresh machine restores it
    bit for bit."""
    client = FakeS3Client(tmp_path / 's3', limit=4096)
    monkeypatch.setitem(sys.modules, 'boto3',
                        types.SimpleNamespace(client=lambda name: client))
    io_utils._BACKENDS.pop('s3', None)
    machine = dict(stage='stage1')
    monkeypatch.setattr(ckpt, 'resolve_checkpoint_dir', lambda uri: (
        str(tmp_path / machine['stage']), uri.rstrip('/')))
    try:
        _, _, state, step = make()
        state = run(state, step, 2)
        mgr = CheckpointManager(URI, interval=2)
        assert mgr.save(state)
        mgr.close()
        size = os.path.getsize(tmp_path / 'stage1' / '2' / 'state.pt')
        assert isinstance(io_utils.get_file_backend(URI), io_utils.S3Backend)
        up = [c for c in client.calls if c[0] == 'upload_file']
        assert up == [('upload_file', 'job1/2/state.pt',
                       -(-size // client.limit))] and up[0][2] > 1
        assert sorted(c[1] for c in client.calls if c[0] == 'put_object') \
            == ['job1/latest.txt', 'job1/manifest-2.txt']
        machine['stage'] = 'stage2'
        _, _, fresh, _ = make(seed=5)
        CheckpointManager(URI).restore(fresh)
        assert client.calls[-1] == ('download_file', 'job1/2/state.pt',
                                    up[0][2])
        assert_bitwise(fresh, state)
    finally:
        io_utils._BACKENDS.pop('s3', None)
