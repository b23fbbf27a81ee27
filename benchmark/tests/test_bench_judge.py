"""The comparison's own arithmetic on made-up images: the render's
mismatch share, the measured surface's normals and the surfels' angle
to them."""
import numpy as np

from reference import range_image as ri
from reference.judge import normal_deg, render_mismatch


def test_render_mismatch_counts_alpha_everywhere_and_depth_where_covered():
    alpha = np.full((4, 8), 0.9)
    depth = np.full((4, 8), 10.0)
    assert render_mismatch(alpha, depth, alpha, depth) == 0.0
    a, d = alpha.copy(), depth.copy()
    a[0, 0] = 0.0                    # a pixel the program left uncovered
    d[1, 1] *= 1 + 1e-4              # a covered pixel's depth off
    assert render_mismatch(a, d, alpha, depth) == 2 / 32
    low = np.full((4, 8), 0.3)       # nobody covers: depth is not judged
    assert render_mismatch(low, depth * 2, low, depth) == 0.0


def test_surface_normals_of_a_wall():
    rng = np.random.default_rng(0)
    az = rng.uniform(-0.5, 0.5, 20000)
    el = rng.uniform(-0.3, 0.3, 20000)
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1)
    cloud = (5.0 / d[:, :1] * d).astype(np.float32)   # the wall x = 5
    depth, valid, _, pts = ri.range_image(cloud, 32, 256, 1.0, 60.0,
                                          points=True)
    np.testing.assert_allclose(np.linalg.norm(pts, axis=-1)[valid],
                               depth[valid])
    n, where = ri.surface_normals(pts, valid)
    assert where.sum() > 0.5 * valid.sum()
    np.testing.assert_allclose(n[where], [[-1.0, 0.0, 0.0]] * where.sum(),
                               atol=1e-6)


def test_normal_deg_takes_the_worst_sector():
    h, w = 4, 256                    # two sectors of 128 columns
    surface = np.zeros((h, w, 3))
    surface[..., 0] = -1.0
    normal = surface * 0.5           # composited, not normalised
    where = np.ones((h, w), bool)
    assert normal_deg(normal, where, surface, where) < 1e-6
    turned = normal.copy()
    c, s = np.cos(np.radians(60)), np.sin(np.radians(60))
    turned[:, 128:] = 0.5 * np.array([-c, s, 0.0])
    assert abs(normal_deg(turned, where, surface, where) - 60.0) < 1e-6
    assert normal_deg(normal, ~where, surface, where) == np.inf
