"""ekf_slam_tpu_torch.ops.occupancy against ekf_slam_tpu.ops.occupancy on
the CPU: the JAX package's three cases (tests/test_occupancy.py), beams
that leave the grid, invalid beams, a heading across 0/360, and
update_grid and map_session from the same non-zero grid (carried across
by convert.grid_from_numpy).

The tolerance.  A sample's cell is decided by a floor, so a sample within
an ulp of a cell edge may land in the next cell on one side: the two
packages' degree trig agrees within an ulp, not to the bit, and XLA's
compiled map_session fuses pose + r·frac·dir into one multiply-add where
the port rounds twice.  Every other cell is bit-equal: the increments one
scatter adds to a cell are all equal, so their order cannot change the
sum.  So every cell that differs must be one such a sample can reach
(checks.occupancy_edge_budget, in the dtype of the coordinates), and the
rest agree within 1e-12 at f64 and bit for bit at f32.  On random inputs
no sample comes that close at f64, and every cell agrees within 1e-12;
on the aligned room and grid of JAX's own cases, samples fall exactly on
cell edges.  At f32 the cells that differ are also at most
F32_DIFFER_SHARE of the cells either grid touched."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.config import SimConfig as JSimConfig
from ekf_slam_tpu.ops import occupancy as jocc
from ekf_slam_tpu.ops.scan import scan_from_ranges as jscan
from ekf_slam_tpu.sim import world as jw
from ekf_slam_tpu_torch import checks, convert
from ekf_slam_tpu_torch.ops import occupancy as tocc
from ekf_slam_tpu_torch.ops.angles import cosd
from ekf_slam_tpu_torch.ops.scan import scan_from_ranges as tscan

from torch_parity_helpers import n, t

# f64 log-odds: the two packages' sums of the same increments
F64_TOL = 1e-12
# f32: cells that may differ, as a share of the cells either grid touched
# (each must also be reachable by a near-edge sample)
F32_DIFFER_SHARE = checks.OCC_DIFFER_SHARE


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def both_grids(width, height, res, origin, dtype, logodds=None):
    """The same grid in both packages (``logodds`` from numpy, or 0)."""
    jg = jocc.init_grid(width, height, res, origin=origin, dtype=dtype)
    if logodds is not None:
        jg = jg._replace(logodds=jnp.asarray(logodds, dtype))
    tg = convert.grid_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    return jg, tg


def assert_parity(tg, jg, poses, ranges, angles, n_samples=64,
                  coord_dtype=torch.float64, tol=F64_TOL, none_near=False):
    """The port's grid against JAX's after fusing ``ranges`` [T,B] at
    ``poses`` [T,3] (numpy): no cell more than ``tol`` past what its
    near-edge samples can move it (none such with ``none_near``); the
    probabilities agree where no such sample reaches."""
    edge, n_edge = checks.occupancy_edge_budget(
        tuple(tg.logodds.shape), tg.origin, tg.resolution, t(poses),
        t(ranges), t(angles), n_samples, dtype=coord_dtype)
    cmp = checks.occupancy_compare(tg.logodds, t(jg.logodds), edge, tol=tol)
    assert cmp["n_unexplained"] == 0, cmp
    if none_near:
        assert n_edge == 0 and cmp["n_differ"] == 0, (n_edge, cmp)
    same = (edge == 0).numpy()
    np.testing.assert_allclose(
        n(tocc.occupancy_probability(tg))[same],
        n(jocc.occupancy_probability(jg))[same], rtol=1e-14, atol=1e-15)
    return cmp, n_edge


def test_single_scan_marks_walls_and_free_space():
    """tests/test_occupancy.py's first case in both packages, f64; the
    port's update_grid updates a copy."""
    jg, tg = both_grids(100, 80, 0.1, (-5.0, -4.0), jnp.float64)
    room = jw.rectangle_room(4.0, 3.0)
    angles = jnp.linspace(0.0, 360.0, 720, endpoint=False)
    pose = jnp.array([0.0, 0.0, 0.0])
    ranges = jw.raycast(room, pose, angles, 12.0)
    jg = jocc.update_grid(jg, jscan(ranges, angles), pose)
    before = tg.logodds.clone()
    tg2 = tocc.update_grid(tg, tscan(t(ranges), t(angles)), t(pose))
    assert torch.equal(tg.logodds, before)
    assert tg2.logodds.dtype == torch.float64
    assert_parity(tg2, jg, np.asarray(pose)[None], np.asarray(ranges)[None],
                  np.asarray(angles))
    p = n(tocc.occupancy_probability(tg2))

    def cell(x, y):
        return p[int((y + 4.0) / 0.1), int((x + 5.0) / 0.1)]
    assert cell(4.0, 0.0) > 0.8 or cell(3.95, 0.0) > 0.8
    assert cell(0.0, 3.0) > 0.8 or cell(0.0, 2.95) > 0.8
    assert cell(0.0, 0.0) < 0.3
    assert cell(2.0, 1.0) < 0.3
    assert abs(cell(4.8, 3.8) - 0.5) < 1e-6


@pytest.fixture(scope="module")
def circle_traj():
    cfg = JSimConfig(n_beams=360, max_range=12.0, range_noise_std=0.0,
                     odom_xy_noise_std=0.0, odom_theta_noise_std=0.0)
    return jw.simulate(jw.rectangle_room(4.0, 3.0),
                       jw.circle_controls(60, 0.05, 6.0), cfg,
                       jax.random.PRNGKey(0))


def test_map_session_full_trajectory(circle_traj):
    """tests/test_occupancy.py's second case in both packages: 60 scans
    at the true poses, f64."""
    tr = circle_traj
    jg, tg = both_grids(100, 80, 0.1, (-5.0, -4.0), jnp.float64)
    jg = jocc.map_session(jg, tr.truth, tr.ranges, tr.beam_angles)
    tg = tocc.map_session(tg, t(tr.truth), t(tr.ranges), t(tr.beam_angles))
    assert tg.logodds.dtype == torch.float64
    assert_parity(tg, jg, np.asarray(tr.truth), np.asarray(tr.ranges),
                  np.asarray(tr.beam_angles))
    p = n(tocc.occupancy_probability(tg))
    assert (p > 0.9).sum() > 50
    assert (p[30:50, 35:65] < 0.1).mean() > 0.9


def test_grid_clamp_mixed_dtypes():
    """tests/test_occupancy.py's third case: an f32 grid fed f64 ranges
    and pose 20 times under jax.jit (the coordinates in f64, the
    increments in f32), clamped at ±10, against JAX's."""
    jg, tg = both_grids(64, 64, 0.25, (-8.0, -8.0), jnp.float32)
    angles = jnp.linspace(0.0, 360.0, 90, endpoint=False)
    ranges = jnp.full((90,), 2.0)
    pose = jnp.array([0.0, 0.0, 0.0])
    f = jax.jit(lambda g: jocc.update_grid(g, jscan(ranges, angles), pose))
    ts = tscan(t(ranges), t(angles))
    for _ in range(20):
        jg = f(jg)
        tg = tocc.update_grid(tg, ts, t(pose))
    assert tg.logodds.dtype == torch.float32
    assert_parity(tg, jg, np.asarray(pose)[None], np.asarray(ranges)[None],
                  np.asarray(angles), tol=0.0)
    lo = n(tg.logodds)
    assert lo.max() == 10.0 and lo.min() == -10.0


def test_beams_leaving_the_grid_and_invalid_beams():
    """A robot near the grid's corner whose long beams leave it, and
    NaN, inf, zero and negative ranges: out-of-grid and invalid samples
    add nothing (cell (0, 0) included); equal to JAX at f64."""
    rng = np.random.default_rng(3)
    B = 180
    angles = np.linspace(0.0, 360.0, B, endpoint=False)
    ranges = rng.uniform(0.5, 9.0, B)
    ranges[::7] = np.nan
    ranges[1::11] = np.inf
    ranges[2::13] = 0.0
    ranges[3::17] = -1.0
    pose = np.array([0.7, 0.4, 33.0])
    jg, tg = both_grids(40, 30, 0.1, (0.0, 0.0), jnp.float64)
    jg = jocc.update_grid(jg, jscan(jnp.asarray(ranges), jnp.asarray(angles)),
                          jnp.asarray(pose))
    tg = tocc.update_grid(tg, tscan(t(ranges), t(angles)), t(pose))
    assert_parity(tg, jg, pose[None], ranges[None], angles, none_near=True)
    # many valid beams end outside the 4 m × 3 m grid; had their outside
    # samples added at cell (0, 0), parity would fail there
    end = pose[:2] + ranges[:, None] * np.stack(
        [np.cos(np.deg2rad(angles + pose[2])),
         np.sin(np.deg2rad(angles + pose[2]))], -1)
    ok = np.isfinite(ranges) & (ranges > 0)
    assert (~((end[ok] >= 0) & (end[ok] < [4.0, 3.0])).all(-1)).sum() > 50
    assert np.count_nonzero(n(tg.logodds)) > 100


def test_heading_across_the_seam_from_a_nonzero_grid():
    """map_session over poses whose heading crosses 0/360 (359.2 → 0.4
    → 1.9 and back), starting from a random non-zero grid carried across
    by convert.grid_from_numpy: equal to JAX at f64; update_grid too."""
    rng = np.random.default_rng(7)
    T, B = 6, 240
    angles = np.arange(B) * (360.0 / B)
    heads = np.array([358.1, 359.2, 0.4, 1.9, 0.0, 359.9])
    poses = np.stack([rng.uniform(-1, 1, T), rng.uniform(-1, 1, T), heads],
                     -1)
    ranges = rng.uniform(0.2, 6.0, (T, B))
    ranges[rng.random((T, B)) < 0.05] = np.nan
    lo0 = rng.uniform(-10.0, 10.0, (70, 90))
    jg, tg = both_grids(90, 70, 0.1, (-4.5, -3.5), jnp.float64, logodds=lo0)
    np.testing.assert_array_equal(n(tg.logodds), lo0)
    jm = jocc.map_session(jg, jnp.asarray(poses), jnp.asarray(ranges),
                          jnp.asarray(angles), n_samples=32)
    tm = tocc.map_session(tg, t(poses), t(ranges), t(angles), n_samples=32)
    assert_parity(tm, jm, poses, ranges, angles, 32, none_near=True)
    ju = jocc.update_grid(jg, jscan(jnp.asarray(ranges[2]),
                                    jnp.asarray(angles)),
                          jnp.asarray(poses[2]), n_samples=16, l_free=-0.3,
                          l_occ=1.5, clamp=8.0)
    tu = tocc.update_grid(tg, tscan(t(ranges[2]), t(angles)), t(poses[2]),
                          n_samples=16, l_free=-0.3, l_occ=1.5, clamp=8.0)
    assert_parity(tu, ju, poses[2:3], ranges[2:3], angles, 16, none_near=True)


@pytest.fixture(scope="module")
def f32_case():
    """A noisy 30-tick arc of 720 beams, all f32, fused at 0.05 m into a
    grid that starts from random log-odds (so few cells saturate): the
    grids of both packages and what each cell's near-edge samples can
    move it."""
    rng = np.random.default_rng(11)
    T = 30
    cfg = JSimConfig(n_beams=720, max_range=12.0, range_noise_std=0.01)
    tr = jw.simulate(jw.rectangle_room(4.0, 3.0),
                     jw.circle_controls(T, 0.05, 4.5), cfg,
                     jax.random.PRNGKey(2), start_pose=(0.3, -0.2, 10.0))
    poses = np.asarray(tr.truth, np.float32)
    ranges = np.asarray(tr.ranges, np.float32)
    angles = np.asarray(tr.beam_angles, np.float32)
    lo0 = rng.uniform(-3.0, 3.0, (140, 180)).astype(np.float32)
    jg, tg = both_grids(180, 140, 0.05, (-4.5, -3.5), jnp.float32,
                        logodds=lo0)
    jm = jocc.map_session(jg, jnp.asarray(poses), jnp.asarray(ranges),
                          jnp.asarray(angles))
    tm = tocc.map_session(tg, t(poses), t(ranges), t(angles))
    budget, n_edge = checks.occupancy_edge_budget(
        (140, 180), (-4.5, -3.5), 0.05, t(poses), t(ranges), t(angles))
    return dict(T=T, poses=poses, ranges=ranges, angles=angles, tg=tg,
                jm=t(jm.logodds), tm=tm, budget=budget, n_edge=n_edge)


def test_map_session_f32_parity(f32_case):
    """f32: every cell bit-equal to JAX's, but where a sample within
    OCC_EDGE_ULPS of a cell edge reaches it, and there by no more than
    those samples' increments; the cells that differ at most
    F32_DIFFER_SHARE of the cells touched."""
    c = f32_case
    assert c["tm"].logodds.dtype == torch.float32
    cmp = checks.occupancy_compare(c["tm"].logodds, c["jm"], c["budget"])
    assert cmp["n_unexplained"] == 0, cmp
    assert cmp["n_differ"] <= F32_DIFFER_SHARE * cmp["n_touched"], cmp
    # the near-edge samples are a small share of the T × 720 × 65
    assert 0 < c["n_edge"] < 0.02 * c["T"] * 720 * 65
    lo = n(c["tm"].logodds)
    assert ((np.abs(lo) < 10) & (lo != n(c["tg"].logodds))).sum() > 1000


def test_map_session_f32_control_fails(f32_case):
    """The comparison can fail: the same fusion with the last scan's
    occupied adds dropped (l_occ 0), or with the last pose moved by half
    a cell, leaves cells further from JAX's than their near-edge samples
    can move them."""
    c = f32_case
    P, R, A = t(c["poses"]), t(c["ranges"]), t(c["angles"])
    g = tocc.map_session(c["tg"], P[:-1], R[:-1], A)
    cut = tocc.update_grid(g, tscan(R[-1], A), P[-1], l_occ=0.0)
    cmp = checks.occupancy_compare(cut.logodds, c["jm"], c["budget"])
    assert cmp["n_unexplained"] > 0, cmp
    P2 = P[-1].clone()
    P2[0] += 0.025
    moved = tocc.update_grid(g, tscan(R[-1], A), P2)
    cmp2 = checks.occupancy_compare(moved.logodds, c["jm"], c["budget"])
    assert cmp2["n_unexplained"] > 0, cmp2


def test_compare_counts_the_cells_its_budget_cannot_hold():
    """A touched cell whose budget reaches twice the clamp is counted in
    n_unheld, since no gap can pass it there; a touched cell with a
    smaller budget, or an untouched one, is not."""
    a = torch.zeros(3, 4, dtype=torch.float32)
    b = a.clone()
    a[0, 0], b[0, 0] = 5.0, -5.0
    a[1, 1] = 1.0
    budget = torch.zeros(3, 4, dtype=torch.float64)
    budget[0, 0], budget[1, 1], budget[2, 2] = 20.0, 19.9, 25.0
    cmp = checks.occupancy_compare(a, b, budget)
    assert (cmp["n_differ"], cmp["n_unexplained"], cmp["n_touched"],
            cmp["n_unheld"]) == (2, 0, 2, 1), cmp
    assert checks.occupancy_compare(a, b, budget, clamp=5.0)["n_unheld"] == 2


def test_edge_scale_covers_the_port_f32_coordinates():
    """The unit of checks.occupancy_edge_budget's δ (the f32 epsilon times
    the magnitudes rounded, over the resolution) holds the port's f32
    grid coordinates within half a unit of their exact values, at poses
    up to 90 m from the origin and ranges up to 10 m, so OCC_EDGE_ULPS
    (4) leaves 8 times that for other devices' last ulps."""
    import math
    rng = np.random.default_rng(17)
    B, S, res, ox = 512, 64, 0.05, -101.3
    angles = torch.arange(B, dtype=torch.float32) * (360.0 / B)
    frac = tocc._fractions(S, torch.float32, "cpu")
    worst = 0.0
    for _ in range(40):
        pose = torch.tensor([rng.uniform(-90, 90), rng.uniform(-90, 90),
                             rng.uniform(0, 360)], dtype=torch.float32)
        r = torch.tensor(rng.uniform(0.1, 10.0, B), dtype=torch.float32)
        # the port's f32 arithmetic (ops/occupancy._fuse_), x only
        wa = angles + pose[2]
        x = pose[0] + (r[:, None] * frac[None, :]) * cosd(wa)[:, None]
        u32 = (x - torch.tensor(ox)) / torch.tensor(res)
        # exact, and the unit, as occupancy_edge_budget computes them
        P, R = pose.double(), r.double()
        rad = (angles.double() + P[2]) * (math.pi / 180.0)
        d = R[:, None] * frac.double()[None, :]
        x64 = P[0] + d * torch.cos(rad)[:, None]
        y64 = P[1] + d * torch.sin(rad)[:, None]
        u64 = (x64 - ox) / res
        mag = (P[0].abs() + P[1].abs() + abs(ox) + abs(ox)
               + (R * (1.0 + rad.abs()))[:, None] + x64.abs() + y64.abs())
        unit = torch.finfo(torch.float32).eps * (
            mag / res + u64.abs() + ((y64 - ox) / res).abs())
        worst = max(worst, float(((u32.double() - u64).abs() / unit).max()))
    assert 0 < worst <= 0.5, worst
    assert checks.OCC_EDGE_ULPS >= 8 * worst


def test_init_grid_device_rule(monkeypatch):
    """init_grid resolves its device: CUDA, or raise without one; on an
    explicit CPU its fields are the JAX grid's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tocc.init_grid(4, 3, 0.5)
    g = tocc.init_grid(4, 3, 0.5, origin=(1.0, -2.0), dtype=torch.float64,
                       device="cpu")
    jg = jocc.init_grid(4, 3, 0.5, origin=(1.0, -2.0), dtype=jnp.float64)
    assert g.logodds.shape == jg.logodds.shape == (3, 4)
    np.testing.assert_array_equal(n(g.origin), n(jg.origin))
    assert g.resolution == jg.resolution == 0.5
