"""The port's plan builder (pdunet_tpu_torch/geometry.py) against the JAX
package's: same float64 plan math, so every array and every ``meta`` entry
must be equal, not merely close."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.geometry import GOLDEN_ANGLE
from pdunet_tpu.geometry import ParallelGeometry as JaxGeometry
from pdunet_tpu.geometry import build_parallel_plan as jax_plan
from pdunet_tpu_torch.geometry import ParallelGeometry, build_parallel_plan
from pdunet_tpu_torch.ops.radon.parallel import parallel_backproject, parallel_project

torch.set_num_threads(1)


def _assert_same_plan(jp, tp):
    assert jp.meta == tp.meta
    for name in tp.ARRAY_FIELDS:
        a = np.asarray(getattr(jp, name))
        b = getattr(tp, name).numpy()
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(b, a, err_msg=name)


_CASES = {
    "32_24": dict(image_size=32, n_angles=24, det_count=32),
    "32_21": dict(image_size=32, n_angles=21, det_count=32),
    "16_12_spacing": dict(image_size=16, n_angles=12, det_count=20,
                          det_spacing=0.75, pixel_spacing=1.25),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plan_equals_jax(case, bf16):
    kw = _CASES[case]
    jp = jax_plan(JaxGeometry(**kw), dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tp = build_parallel_plan(ParallelGeometry(**kw),
                             dtype=torch.bfloat16 if bf16 else torch.float32,
                             device="cpu")
    _assert_same_plan(jp, tp)


def test_serving_plan_equals_jax():
    """The pdunet_parallel sparse scan: 256², 360 angles kept 4× sparse."""
    jp = jax_plan(JaxGeometry(image_size=256, n_angles=360).subsample(4))
    tp = build_parallel_plan(ParallelGeometry(image_size=256, n_angles=360).subsample(4),
                             device="cpu")
    _assert_same_plan(jp, tp)
    m = tp.meta
    assert (m["N"], m["S"], m["M"], m["S_ext"], m["K"]) == (256, 256, 51, 358, 180)
    assert (m["A_x"], m["A_y"], m["P_x"], m["P_y"]) == (45, 45, 23, 23)
    assert m["use_pairs"]
    # one unpaired angle per group (θ=0 in x, θ=π/2 in y): the mask path runs
    assert tp.pair_msk_x.sum().item() == 22 and tp.pair_msk_y.sum().item() == 22


def test_unpaired_plan_equals_jax_and_is_refused():
    """A golden-angle plan equals JAX's and is refused by the pair path
    (use_pairs false, no pair rows): the per-angle operators take it."""
    angles = tuple((k * GOLDEN_ANGLE) % math.pi for k in range(16))
    jp = jax_plan(JaxGeometry(image_size=32, angles=angles))
    tp = build_parallel_plan(ParallelGeometry(image_size=32, angles=angles), device="cpu")
    _assert_same_plan(jp, tp)
    assert not tp.meta["use_pairs"]
    assert tp.meta["P_x"] == tp.meta["P_y"] == 0 and tp.pair_pos_x.shape == (0, 32)
    assert parallel_project(tp, torch.zeros(32, 32)).shape == (16, 32)
    assert parallel_backproject(tp, torch.zeros(16, 32)).shape == (32, 32)


def test_subsample_and_defaults():
    g = ParallelGeometry(image_size=20, n_angles=12)
    assert g.det_count == 20 and len(g.angles) == 12
    s = g.subsample(3)
    assert s.n_angles == 4 and s.angles == g.angles[::3]
    with pytest.raises(ValueError):
        ParallelGeometry(image_size=8)
    with pytest.raises(ValueError, match="dtype"):
        build_parallel_plan(g, dtype=torch.float16, device="cpu")
