"""Port parity: the plain version of the inverse-CDF kernel
(arcflow_tpu_torch.ops.gm.inverse_cdf.gm1d_inverse_cdf_ref) and its wrapper
on CPU tensors, against the JAX package.

Two references: the TPU kernel ``gm1d_inverse_cdf_pallas`` run in Pallas
interpret mode, as tests/test_inverse_cdf_pallas.py runs it, at atol 5e-4
(its Abramowitz-Stegun erf is within 1.5e-7 of erf, and its roots move by
that over the slope); and the JAX jnp path (``gm1d_inverse_cdf(...,
use_pallas=False)``) at atol 1e-5 plus what fp32 rounding of the cdf (taken
as 1e-6) moves a root by, 1e-6 / (2 pdf), on unsaturated targets
(|cdf| < 0.999), where the inversion is well posed. The CUDA kernel runs
only on a card: tests/test_torch_inverse_cdf_cuda.py, which imports no JAX.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arcflow_tpu.ops.gm import gm_ops as j_gm
from arcflow_tpu.ops.gm.inverse_cdf import gm1d_inverse_cdf_pallas
from arcflow_tpu_torch.ops.gm import inverse_cdf as t_icdf

torch.set_num_threads(1)


def problem(seed, b=2, g=4, h=3, w=3, n=5, per_sample=False, logstd=-0.3,
            spread=2.0):
    """A 1-D mixture (b, g, h, w) and targets (b, n, h, w) from true
    samples; with ``per_sample`` the layout of the KR transport's later
    axes: means (b, 1, g, h, w), per-sample log-weights (b, n, g, h, w) and
    targets (b, n, 1, h, w)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    means = (spread * rng.standard_normal((b, g, h, w))).astype(f)
    lw_shape = (b, n, g, h, w) if per_sample else (b, g, h, w)
    logits = rng.standard_normal(lw_shape).astype(f)
    lw = (logits - np.log(np.exp(logits).sum(-3, keepdims=True))).astype(f)
    logstds = np.full((b, 1, 1, 1), logstd, f)
    x_true = (1.5 * rng.standard_normal((b, n, h, w))).astype(f)
    if per_sample:
        means, logstds = means[:, None], logstds[:, None]
        x_true = x_true[:, :, None]
    gm1d = dict(means=means, logstds=logstds, logweights=lw)
    _, cdf = j_gm.gm1d_pdf_cdf({k: jnp.asarray(v) for k, v in gm1d.items()},
                               jnp.asarray(x_true))
    return gm1d, np.asarray(cdf)


def jax_init(gm1d, cdf):
    """The JAX function's initial samples (its isotropic proxy)."""
    return np.asarray(j_gm.gm1d_inverse_cdf(
        {k: jnp.asarray(v) for k, v in gm1d.items()}, jnp.asarray(cdf),
        n_steps=0, backward_steps=0, use_pallas=False))


def args_of(gm1d, cdf, init):
    w = np.exp(gm1d['logweights'])
    return (gm1d['means'], gm1d['logweights'], w, gm1d['logstds'], cdf, init)


def run_ref(args, n_steps):
    out = t_icdf.gm1d_inverse_cdf_ref(*(torch.from_numpy(np.asarray(a))
                                        for a in args), n_steps=n_steps)
    return out.numpy()


def run_pallas(args, n_steps):
    with pltpu.force_tpu_interpret_mode():
        out = gm1d_inverse_cdf_pallas(*(jnp.asarray(a) for a in args),
                                      n_steps=n_steps)
    return np.asarray(out)


CASES = {
    'base': dict(),
    'ragged_m': dict(b=1, h=5, w=39),           # M = 195: not 128 or 512
    'm_over_512': dict(b=3, h=13, w=17),        # M = 663, two 512 tiles
    'g1': dict(g=1),
    'n1': dict(n=1),
    'n5_per_sample': dict(n=5, per_sample=True),
}


@pytest.mark.parametrize('case', list(CASES))
def test_ref_matches_pallas_kernel_in_interpret_mode(case):
    gm1d, cdf = problem(1, **CASES[case])
    args = args_of(gm1d, cdf, jax_init(gm1d, cdf))
    got, want = run_ref(args, 12), run_pallas(args, 12)
    assert got.shape == want.shape == np.broadcast_shapes(
        cdf.shape, gm1d['means'].shape[:-3] + (1,) + cdf.shape[-2:])
    mask = np.abs(cdf) < 0.999
    np.testing.assert_allclose(got[mask], want[mask], atol=5e-4)


@pytest.mark.parametrize('case', list(CASES))
def test_ref_matches_the_jnp_path(case):
    gm1d, cdf = problem(2, **CASES[case])
    j_gm1d = {k: jnp.asarray(v) for k, v in gm1d.items()}
    want = np.asarray(j_gm.gm1d_inverse_cdf(
        j_gm1d, jnp.asarray(cdf), n_steps=16, backward_steps=0,
        use_pallas=False))
    got = run_ref(args_of(gm1d, cdf, jax_init(gm1d, cdf)), 16)
    mask = np.abs(cdf) < 0.999
    assert mask.mean() > 0.7
    pdf, _ = j_gm.gm1d_pdf_cdf(j_gm1d, jnp.asarray(want))
    tol = 1e-5 + 1e-6 / (2 * np.asarray(pdf))
    err = np.abs(got - want)
    assert (err <= tol)[mask].all(), (err - tol)[mask].max()


def test_saturated_targets_stay_finite():
    """Targets at and next to +-1: the pdf underflows and every step is the
    clamp; the output stays finite in the plain version and in the Pallas
    kernel."""
    gm1d, cdf = problem(3)
    cdf = cdf.copy()
    cdf[0, 0] = 1.0
    cdf[0, 1] = -1.0
    cdf[1, 0] = 0.9999999
    cdf[1, 1] = -0.99999
    init = jax_init(gm1d, cdf)
    for run in (run_ref, run_pallas):
        out = run(args_of(gm1d, cdf, init), 16)
        assert np.isfinite(out).all()
    # a step is never longer than max_step_size * std
    one = run_ref(args_of(gm1d, cdf, init), 1)
    assert np.abs(one - init).max() <= 1.5 * np.exp(-0.3) * (1 + 1e-6)


def test_pdf_below_eps_takes_clamped_steps():
    """Narrow components far apart (std e^-6) and targets in the gaps: the
    pdf falls below eps = 1e-6, so max(pdf, eps) keeps the step finite and
    the clamp bounds it; both versions take the same clamped steps."""
    gm1d, cdf = problem(4, logstd=-6.0, spread=4.0)
    means = gm1d['means']
    init = (means[:, :1] + means[:, 1:2]) / 2 * np.ones_like(cdf)
    j_gm1d = {k: jnp.asarray(v) for k, v in gm1d.items()}
    pdf, _ = j_gm.gm1d_pdf_cdf(j_gm1d, jnp.asarray(init))
    assert (np.asarray(pdf) < 1e-6).mean() > 0.5
    args = args_of(gm1d, cdf, init)
    got, want = run_ref(args, 3), run_pallas(args, 3)
    assert np.isfinite(got).all()
    assert np.abs(got - init).max() <= 3 * 1.5 * np.exp(-6.0) * (1 + 1e-5)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    gm1d, cdf = problem(5, n=3)
    args = [torch.from_numpy(np.asarray(a))
            for a in args_of(gm1d, cdf, jax_init(gm1d, cdf))]
    before = t_icdf.LAUNCHES
    got = t_icdf.gm1d_inverse_cdf_kernel(*args, n_steps=7)
    want = t_icdf.gm1d_inverse_cdf_ref(*args, n_steps=7)
    assert torch.equal(got, want) and t_icdf.LAUNCHES == before


def test_layout_round_trips_broadcast_leading_axes():
    """The (rows, M) layout puts M in (*lead, H, W) order and comes back:
    a mixture shared over a leading axis the targets have."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 4, 3, 5)).astype(np.float32))
    tgt = torch.zeros(2, 6, 3, 5)
    lead, h, w, m = t_icdf._layout(x, tgt)
    assert (lead, h, w, m) == ((2,), 3, 5, 30)
    rows = t_icdf._to_rows(x, lead, 4, h, w, m)
    assert rows.shape == (4, 30) and rows.is_contiguous()
    back = t_icdf._from_rows(rows, lead, h, w)
    assert torch.equal(back, x.expand(2, 4, 3, 5))


def test_wrapper_refuses_other_devices():
    gm1d, cdf = problem(7, n=1)
    args = [torch.from_numpy(np.asarray(a))
            for a in args_of(gm1d, cdf, jax_init(gm1d, cdf))]
    args[4] = args[4].to('meta')
    with pytest.raises(ValueError, match='no inverse-CDF kernel'):
        t_icdf.gm1d_inverse_cdf_kernel(*args)


def _torch_args(case, seed=8):
    gm1d, cdf = problem(seed, **CASES[case])
    return [torch.from_numpy(np.asarray(a))
            for a in args_of(gm1d, cdf, jax_init(gm1d, cdf))]


def _read_back(geom, i, elem):
    """Tensor ``i`` of a ``kernel_geometry`` as the kernel indexes it, by
    ``torch.as_strided`` from its merged sizes and strides, in the (rows, M)
    form of ``kernel_layout``."""
    t, st = geom['inputs'][i], geom['strides'][i]
    n = elem[-3]
    if i < 3:                                # means, logw, w: (G, M)
        g = geom['g']
        v = torch.as_strided(t, (g, *geom['sizes']),
                             (geom['gstrides'][i], *st), t.storage_offset())
        return v.reshape(g, *elem).select(-3, 0).reshape(g, -1)
    v = torch.as_strided(t, geom['sizes'], st, t.storage_offset())
    v = v.reshape(elem)
    if i == 3:                               # logstd: (1, M)
        return v.select(-3, 0).reshape(1, -1)
    return v.movedim(-3, 0).reshape(n, -1)   # target, init: (N, M)


@pytest.mark.parametrize('case', list(CASES))
def test_kernel_geometry_reads_the_plain_layout(case):
    """What the wrapper hands the kernel (views, merged sizes, strides),
    read back with ``torch.as_strided``, is exactly the (rows, M) layout of
    ``kernel_layout``; the output is the (..., N, H, W) result itself; no
    fp32 input is copied."""
    args = _torch_args(case)
    rows, (lead, h, w) = t_icdf.kernel_layout(*args)
    geom = t_icdf.kernel_geometry(*args)
    elem = lead + (args[4].shape[-3], h, w)
    for i in range(6):
        assert torch.equal(_read_back(geom, i, elem), rows[i]), i
        assert geom['inputs'][i].data_ptr() == args[i].data_ptr(), i
    assert geom['out'].shape == elem and geom['out'].is_contiguous()
    assert geom['strides'][6] == list(torch.empty(geom['sizes']).stride())
    assert geom['elements'] == math.prod(elem)


def test_kernel_geometry_of_the_kr_axes():
    """The KR transport's per-axis problems read out of channel-last
    tensors: axis 0 merges into one element dim, a later axis (per-sample
    weights, means broadcast over the samples) into two; both read back as
    ``kernel_layout``'s rows."""
    rng = np.random.default_rng(9)
    f = np.float32
    b, k, n, h, w, c = 1, 16, 3, 8, 8, 4
    means = torch.from_numpy(rng.standard_normal((b, k, h, w, c)).astype(f))
    lw0 = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((b, k, h, w, 1)).astype(f)), 1)[..., 0]
    ls = torch.full((b, 1, 1, 1), -1.0)
    z = torch.from_numpy(rng.standard_normal((b, n, h, w, c)).astype(f))
    tgt = torch.erf(z / math.sqrt(2))
    axis0 = (means[..., 0], lw0, lw0.exp(), ls, tgt[..., 0], z[..., 0])
    lw1 = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((b, n, k, h, w)).astype(f)), 2)
    axis1 = (means[..., 1].unsqueeze(-4), lw1, lw1.exp(), ls.unsqueeze(-4),
             tgt[..., 1].unsqueeze(-3), z[..., 1].unsqueeze(-3))
    for args, dims in ((axis0, [n, h * w]), (axis1, [n, h * w])):
        rows, (lead, hh, ww) = t_icdf.kernel_layout(*args)
        geom = t_icdf.kernel_geometry(*args)
        assert geom['sizes'] == dims
        elem = lead + (args[4].shape[-3], hh, ww)
        for i in range(6):
            assert torch.equal(_read_back(geom, i, elem), rows[i]), i


@pytest.mark.parametrize('g,elements,lanes', [
    (16, 16384, 4),           # the KR axis: 65,536 threads
    (16, 8192, 8),
    (16, 1 << 20, 1),         # a million elements fill the card alone
    (1, 16384, 1),            # one component: nothing to share
    (5, 1024, 8),
    (16, 1961, 16),           # a ragged M = 37 x 53
    (64, 1 << 20, 4),         # at most 16 components a lane
    (256, 1 << 20, 16),
])
def test_lanes_for(g, elements, lanes):
    assert t_icdf.lanes_for(g, elements) == lanes
    assert -(-g // lanes) <= t_icdf.MAX_PER_LANE


def test_merge_dims():
    # contiguous (2, 3, 4) and a tensor broadcast over the middle axis:
    # only the inner pair merges for both; size-1 axes drop
    sizes, strides = t_icdf.merge_dims((2, 1, 3, 4),
                                       [(12, 12, 4, 1), (4, 4, 0, 1)])
    assert sizes == [2, 3, 4] and strides == [[12, 4, 1], [4, 0, 1]]
    sizes, strides = t_icdf.merge_dims((2, 3, 4), [(12, 4, 1), (0, 0, 0)])
    assert sizes == [24] and strides == [[1], [0]]
    assert t_icdf.merge_dims((1, 1), [(5, 1)]) == ([1], [[0]])


def test_launch_refuses_more_components_than_the_lanes_hold():
    """G = 257 needs more than 16 lanes x 16 slots: refused before any
    library is loaded."""
    gm1d, cdf = problem(10, g=257, n=1)
    args = [torch.from_numpy(np.asarray(a))
            for a in args_of(gm1d, cdf, jax_init(gm1d, cdf))]
    with pytest.raises(ValueError, match='G=257'):
        t_icdf.launch(t_icdf.kernel_geometry(*args), 4, 1e-6, 1.5)
