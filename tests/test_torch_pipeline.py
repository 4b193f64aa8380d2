"""The port's angular subsampling and re-expansion
(pdunet_tpu_torch/data/pipeline.py) against the JAX package's, on the same
numpy sinograms: both coverage branches (the detector-flip wrap of a full
scan, the clamp of a limited-angle one), odd and even factors. ≤ 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.data.pipeline import interp_upsample_angles as jax_interp
from pdunet_tpu.data.pipeline import subsample_angles as jax_subsample
from pdunet_tpu_torch.data.pipeline import interp_upsample_angles, subsample_angles

torch.set_num_threads(1)


def _sino(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("factor", [2, 3, 4, 5])
def test_subsample_angles_matches_jax(factor):
    x = _sino(0, (2, 40, 17))
    out = subsample_angles(torch.from_numpy(x), factor)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_subsample(jnp.asarray(x), factor)))


@pytest.mark.parametrize("coverage", [1.0, 0.75], ids=["full_wrap", "limited_clamp"])
@pytest.mark.parametrize("factor", [2, 3, 4, 5])
def test_interp_upsample_angles_matches_jax(factor, coverage):
    x = _sino(factor, (2, 3, 9, 21))  # leading batch dims pass through
    out = interp_upsample_angles(torch.from_numpy(x), factor, coverage)
    ref = np.asarray(jax_interp(jnp.asarray(x), factor, coverage))
    assert out.shape == ref.shape == (2, 3, 9 * factor, 21)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("coverage", [1.0, 0.75], ids=["full_wrap", "limited_clamp"])
def test_interp_passes_measured_rows_and_wraps_with_flip(coverage):
    """Rows i % k == 0 are the measured rows exactly (what hard data
    consistency re-imposes); past the last measured row a full scan blends
    toward angle 0 with the detector flipped, a limited scan holds the last
    row."""
    k = 4
    x = torch.from_numpy(_sino(7, (1, 6, 11)))
    up = interp_upsample_angles(x, k, coverage)
    assert torch.equal(up[:, ::k], x)
    tail = up[0, 5 * k + 2]  # halfway between the last row and the wrap
    other = x[0, 0].flip(-1) if coverage >= 1.0 else x[0, 5]
    torch.testing.assert_close(tail, 0.5 * x[0, 5] + 0.5 * other)


def test_interp_on_a_real_sinogram_of_the_port():
    """A projector-made sinogram of the dense plan: the re-expansion of its
    4x subsampling matches JAX's on the port's own data."""
    from pdunet_tpu_torch.geometry import ParallelGeometry
    from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops

    ops = make_parallel_ops(ParallelGeometry(image_size=32, n_angles=40), device="cpu")
    img = torch.from_numpy(_sino(3, (2, 32, 32)))
    sino = ops.A(img)
    up = interp_upsample_angles(subsample_angles(sino, 4), 4)
    ref = jax_interp(jax_subsample(jnp.asarray(sino.numpy()), 4), 4)
    np.testing.assert_allclose(up.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6 * float(sino.abs().max()))
