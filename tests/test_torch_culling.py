"""Camera culling of the occupancy grid (``render.renderer.
mark_untrained_grid``) in the PyTorch port against the JAX package's (CPU):
the port projects one camera at a time with explicit multiply-adds where
the JAX package runs one einsum over 16 cameras; the grids must be equal."""

import numpy as np
import pytest

from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu_torch.data.synthetic import orbit_pose, synthetic_intrinsics
from trinerflet_tpu_torch.render import renderer as PR


@pytest.mark.parametrize("n,grid,bound,dtype,focal", [
    (30, 64, 1.5, np.float32, 0.9),    # the CLI scene's cameras (synthetic_intrinsics), 2 cascades
    (30, 64, 1.5, np.float32, 3.0),    # narrow views: part of the inner cascade unseen
    (8, 64, 4.0, np.float32, 0.9),     # cameras inside the box (3 cascades)
    (17, 32, 1.0, np.float64, 4.0),    # float64 poses, a batch past 16
    (3, 32, 2.0, np.float32, 2.0),
])
def test_mark_untrained_grid_matches_jax(n, grid, bound, dtype, focal):
    rng = np.random.default_rng(n)
    poses = np.stack([orbit_pose(np.arccos(1 - 1.6 * (v + 0.5) / n), v * 2.399963 + rng.uniform(0, 0.1),
                                 2.0 + rng.uniform(-0.5, 0.5)) for v in range(n)]).astype(dtype)
    H, W = 60, 80
    intr = (focal * W, focal * W, W / 2.0, H / 2.0)
    assert focal != 0.9 or intr == synthetic_intrinsics(H, W)
    got = PR.mark_untrained_grid(poses, intr, PR.RenderConfig(bound=bound, grid_size=grid))
    want = JR.mark_untrained_grid(poses, intr, JR.RenderConfig(bound=bound, grid_size=grid))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {-1.0, 0.0}
    if focal > 0.9:
        assert 0.01 < (got[0] < 0).mean() < 0.99  # some cells culled, some seen
