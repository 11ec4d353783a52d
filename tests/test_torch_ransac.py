"""ekf_slam_tpu_torch RANSAC extraction against ekf_slam_tpu at float64:
the batched-hypothesis wall search and the one-seed-per-round search
(find_walls) fed the JAX package's own threefry draws (lines, ok and the
remaining pool equal; floats within 1e-10), the
plain version of the wall-search kernel against the JAX greedy rounds at
f64 and f32, the candidate table over several ticks (table and ObsBatch
equal), write-back and the line-fit helpers; and the on-card check of the
wall-search kernel (checks.wall_search_compare) against stand-ins for the
kernel on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.ops import ransac as jr
from ekf_slam_tpu.ops import scan as jscan
from ekf_slam_tpu.sim import world as jw
from ekf_slam_tpu_torch import checks as C
from ekf_slam_tpu_torch.ops import ransac as tr
from ekf_slam_tpu_torch.ops import scan as tscan

from torch_parity_helpers import find_walls_draws, max_rel, n, port, t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


NH, B = 16, 256


def _rp(**kw):
    base = dict(line_consensus=20, bearing_window_deg=20.0, sample_points=8,
                wall_search_timeout=4, table_capacity=32, promote_count=2,
                ref_compat=False, n_hypotheses=NH, dtype=jnp.float64)
    base.update(kw)
    return jc.RansacParams(**base)


def _draws(key):
    """The draws the JAX wall search makes from ``key``
    (ransac.py:314-325)."""
    k_pick, k_sample = jax.random.split(key)
    return (t(jax.random.uniform(k_pick, (NH, B))),
            t(jax.random.uniform(k_sample, (NH, B))))


def _scan(rng, pose, noise=0.01):
    room = jw.rectangle_room(4.0, 3.0)
    beams = jnp.linspace(0.0, 360.0, B, endpoint=False)
    r = jw.raycast(room, jnp.asarray(pose), beams, 12.0)
    r = r + jnp.asarray(rng.normal(0, noise, B))
    return jscan.scan_from_ranges(r, beams)


def _world_points(rng, pose):
    js = _scan(rng, pose)
    return jscan.scan_to_world(js, jnp.asarray(pose)), js.valid


def test_fit_line_and_helpers_match(rng):
    pts = rng.uniform(-4, 4, (B, 2))
    w = rng.random((5, B)) < 0.3
    tm, tb_, tok = tr.fit_line(torch.from_numpy(pts), torch.from_numpy(w))
    for i in range(5):
        jm, jb_, jok = jr.fit_line(jnp.asarray(pts), jnp.asarray(w[i]))
        assert abs(float(tm[i]) - float(jm)) <= 1e-10 * max(1, abs(float(jm)))
        assert abs(float(tb_[i]) - float(jb_)) <= 1e-10 * max(
            1, abs(float(jb_)))
        assert bool(tok[i]) == bool(jok)
    m, b = 0.7, -1.3
    tm, tb_ = (torch.tensor(v, dtype=torch.float64) for v in (m, b))
    assert max_rel(tr.point_line_dist(torch.from_numpy(pts), tm, tb_),
                   jr.point_line_dist(jnp.asarray(pts), m, b)) <= 1e-14
    assert max_rel(tr.perpendicular_foot(tm, tb_),
                   jr.perpendicular_foot(m, b)) <= 1e-15


@pytest.mark.parametrize("kw", [
    dict(), dict(ref_compat=True), dict(refine_passes=2),
    dict(split_gap=1.2, split_kink_deg=10.0, max_fit_rms=0.05)],
    ids=["default", "ref_compat", "refine", "split"])
def test_find_walls_batched_matches(rng, kw):
    p = _rp(**kw)
    pose = np.array([0.4, -0.3, 25.0])
    pts, valid = _world_points(rng, pose)
    key = jax.random.PRNGKey(3)
    want = jr.find_walls_batched(pts, valid, key, p, NH)
    got = tr.find_walls_batched(t(pts), t(valid), port(p), NH,
                                draws=_draws(key))
    lines, ok, remaining, stats = (n(v) for v in got)
    np.testing.assert_array_equal(ok, n(want[1]))
    # the two-quadrant window (ref_compat) merges opposite walls' bearings
    # and finds no wall in this scan — in both packages
    assert ok.any() != p.ref_compat
    np.testing.assert_array_equal(remaining, n(want[2]))
    np.testing.assert_allclose(lines, n(want[0]), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(stats, n(want[3]), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(), dict(writeback_mode="sig", match_mode="nearest"),
    dict(writeback_last_only=False), dict(writeback_mode="off")],
    ids=["ref", "sig-nearest", "ref-all", "off"])
def test_extract_sequence_matches(rng, kw):
    """Six extraction ticks on a moving pose: the table's promotion,
    snapping, decay and write-back, and each tick's ObsBatch, agree."""
    p = _rp(**kw)
    tp = port(p)
    jtab, ttab = jr.init_table(p), tr.init_table(tp, device="cpu")
    K = 6
    x = np.zeros(3 + 2 * K)
    sig = np.zeros(K)
    key = jax.random.PRNGKey(7)
    extract = jax.jit(jr.extract, static_argnums=(5, 6))
    for tick in range(6):
        pose = np.array([0.05 * tick, 0.02 * tick, 3.0 * tick])
        x[:3] = pose
        na = min(tick, K)
        x[3:3 + 2 * na] = rng.uniform(-3, 3, 2 * na)     # "filter" state
        sig[:na] = np.arange(1, na + 1)
        js = _scan(rng, pose)
        key, sub = jax.random.split(key)
        jobs, jtab = extract(jtab, js, jnp.asarray(x), jnp.asarray(na, jnp.int32),
                             sub, p, 8, jnp.asarray(sig))
        ts = tscan.Scan(*(t(v) for v in js))
        tobs, ttab = tr.extract(ttab, ts, torch.from_numpy(x),
                                torch.tensor(na, dtype=torch.int32), tp, 8,
                                sig=torch.from_numpy(sig),
                                draws=_draws(sub))
        for f in ("observe", "index", "fresh", "used"):
            np.testing.assert_array_equal(n(getattr(ttab, f)),
                                          n(getattr(jtab, f)), err_msg=f)
        np.testing.assert_allclose(n(ttab.loc), n(jtab.loc), atol=1e-10)
        np.testing.assert_array_equal(n(tobs.valid), n(jobs.valid))
        np.testing.assert_array_equal(n(tobs.index), n(jobs.index))
        for f in ("rng", "bearing", "loc", "R"):
            np.testing.assert_allclose(n(getattr(tobs, f)),
                                       n(getattr(jobs, f)), rtol=1e-10,
                                       atol=1e-10, err_msg=f)
    assert n(ttab.index).max() > 0                 # something was promoted


def test_update_table_edge_cases_match(rng):
    """No candidates (nothing decays), the empty table seeded with the
    first candidate only, and a full table dropping new candidates."""
    p = _rp(table_capacity=4, freshness=2)
    tp = port(p)
    jtab, ttab = jr.init_table(p), tr.init_table(tp, device="cpu")
    pose = np.array([0.1, 0.2, 10.0])
    cases = [
        (np.zeros((4, 2)), np.zeros(4, bool)),
        (rng.uniform(-3, 3, (4, 2)), np.array([False, True, True, True])),
        (rng.uniform(-3, 3, (4, 2)), np.ones(4, bool)),
        (rng.uniform(-3, 3, (4, 2)), np.ones(4, bool)),
        (np.zeros((4, 2)), np.zeros(4, bool)),
    ]
    for cands, ok in cases:
        jobs, jtab = jr.update_table(jtab, jnp.asarray(cands),
                                     jnp.asarray(ok), jnp.asarray(pose), p, 3)
        tobs, ttab = tr.update_table(ttab, torch.from_numpy(cands),
                                     torch.from_numpy(ok),
                                     torch.from_numpy(pose), tp, 3)
        for f in ("observe", "index", "fresh", "used"):
            np.testing.assert_array_equal(n(getattr(ttab, f)),
                                          n(getattr(jtab, f)), err_msg=f)
        np.testing.assert_allclose(n(ttab.loc), n(jtab.loc), atol=1e-12)
        np.testing.assert_array_equal(n(tobs.valid), n(jobs.valid))
        assert tobs.R is None and jobs.R is None


def test_sequential_wall_search_raises(rng):
    """Named for the NotImplementedError extract raised on n_hypotheses=0
    before the one-seed search was ported.  It now runs; what still
    raises is a set of draws of the wrong shape, which find_walls cannot
    index by round."""
    p = port(_rp(n_hypotheses=0))
    js = _scan(rng, np.zeros(3))
    obs, _ = tr.extract(tr.init_table(p, device="cpu"),
                        tscan.Scan(*(t(v) for v in js)),
                        torch.zeros(9, dtype=torch.float64),
                        torch.tensor(0, dtype=torch.int32), p, 8,
                        draws=find_walls_draws(jax.random.PRNGKey(0), 4, B))
    assert obs.valid.shape == (8,)
    pts = tscan.scan_to_world(tscan.Scan(*(t(v) for v in js)),
                              torch.zeros(3, dtype=torch.float64))
    bad = torch.rand((4, B // 2), dtype=torch.float64)
    with pytest.raises((IndexError, RuntimeError)):
        tr.find_walls(pts, t(js.valid), p, draws=(bad, bad))


@pytest.mark.parametrize("kw", [
    dict(), dict(ref_compat=True), dict(refine_passes=2),
    dict(split_gap=1.2, split_kink_deg=10.0, max_fit_rms=0.05)],
    ids=["default", "ref_compat", "refine", "split"])
@pytest.mark.parametrize("seed", [3, 11])
def test_find_walls_matches(rng, kw, seed):
    """The reference's one-seed-per-round search fed JAX's own threefry
    draws: ok and the remaining pool equal, lines within 1e-10 and fit
    statistics within 1e-10 relative, with the ref_compat bearing (atand
    of y/x, a two-quadrant window) and with the refits, splits and RMS
    gate.  The ref_compat case keeps the beams of one half-turn: the
    two-quadrant window of a full turn holds two opposite walls, and no
    seed line then finds a wall, in either package."""
    p = _rp(n_hypotheses=0, **kw)
    pose = np.array([0.4, -0.3, 25.0])
    pts, valid = _world_points(rng, pose)
    if p.ref_compat:
        valid = valid & (jnp.arange(B) < B // 2)
    key = jax.random.PRNGKey(seed)
    want = jr.find_walls(pts, valid, key, p)
    got = tr.find_walls(t(pts), t(valid), port(p),
                        draws=find_walls_draws(key, p.wall_search_timeout, B))
    lines, ok, remaining, stats = (n(v) for v in got)
    np.testing.assert_array_equal(ok, n(want[1]))
    np.testing.assert_array_equal(remaining, n(want[2]))
    assert ok.any()
    np.testing.assert_allclose(lines[ok], n(want[0])[ok], rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(stats[ok], n(want[3])[ok], rtol=1e-10,
                               atol=1e-12)
    # a rejected round's fit may be a near-vertical line (slope -22 in
    # the ref_compat case) whose denominator Σx² − (Σx)²/n cancels, so
    # the two packages' summation orders part at 1.4e-10 relative there
    np.testing.assert_allclose(lines[~ok], n(want[0])[~ok], rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("ref_compat", [False, True])
def test_extract_sequential_search_matches(rng, ref_compat):
    """extract with n_hypotheses=0 (the JAX default) over six ticks of a
    moving pose, each tick's find_walls draws JAX's own: table and
    ObsBatch equal, as for the batched search."""
    p = _rp(n_hypotheses=0, ref_compat=ref_compat)
    tp = port(p)
    jtab, ttab = jr.init_table(p), tr.init_table(tp, device="cpu")
    K = 6
    x = np.zeros(3 + 2 * K)
    key = jax.random.PRNGKey(7)
    extract = jax.jit(jr.extract, static_argnums=(5, 6))
    for tick in range(6):
        pose = np.array([0.05 * tick, 0.02 * tick, 3.0 * tick])
        x[:3] = pose
        na = min(tick, K)
        x[3:3 + 2 * na] = rng.uniform(-3, 3, 2 * na)
        js = _scan(rng, pose)
        key, sub = jax.random.split(key)
        jobs, jtab = extract(jtab, js, jnp.asarray(x),
                             jnp.asarray(na, jnp.int32), sub, p, 8)
        tobs, ttab = tr.extract(ttab, tscan.Scan(*(t(v) for v in js)),
                                torch.from_numpy(x),
                                torch.tensor(na, dtype=torch.int32), tp, 8,
                                draws=find_walls_draws(
                                    sub, p.wall_search_timeout, B))
        for f in ("observe", "index", "fresh", "used"):
            np.testing.assert_array_equal(n(getattr(ttab, f)),
                                          n(getattr(jtab, f)), err_msg=f)
        np.testing.assert_allclose(n(ttab.loc), n(jtab.loc), atol=1e-10)
        np.testing.assert_array_equal(n(tobs.valid), n(jobs.valid))
        np.testing.assert_array_equal(n(tobs.index), n(jobs.index))
        for f in ("rng", "bearing", "loc", "R"):
            np.testing.assert_allclose(n(getattr(tobs, f)),
                                       n(getattr(jobs, f)), rtol=1e-10,
                                       atol=1e-10, err_msg=f)
    if not ref_compat:
        assert n(ttab.index).max() > 0             # something was promoted


# examples/large_world_slam.py:76-77's extractor settings (refits, both
# splits, the RMS gate)
LARGE_WORLD = dict(line_consensus=36, bearing_window_deg=20.0,
                   wall_search_timeout=9, sample_points=12, inlier_dist=0.15,
                   refine_passes=2, refine_frac=0.4, split_gap=1.2,
                   split_kink_deg=3.0, max_fit_rms=0.04)
WALL_SETS = [dict(), dict(refine_passes=2),
             dict(split_gap=1.2, split_kink_deg=10.0, max_fit_rms=0.05),
             LARGE_WORLD]
WALL_IDS = ["default", "refine", "split", "large_world"]


def _wall_inputs(rng, p, key, dtype):
    """World points, validity and the port's seeded trial lines from the
    JAX wall search's own draws, in ``dtype``."""
    pts, valid = _world_points(rng, np.array([0.4, -0.3, 25.0]))
    pts = jnp.asarray(pts, dtype)
    u, s = _draws(key)
    trial, trial_ok = tr.seed_trials(t(pts), t(valid), port(p), NH,
                                     draws=(u.to(t(pts).dtype),
                                            s.to(t(pts).dtype)))
    return pts, valid, trial, trial_ok


@pytest.mark.parametrize("kw", WALL_SETS, ids=WALL_IDS)
def test_wall_search_ref_matches_jax_f64(rng, kw):
    """The plain version of the wall-search kernel, fed the trial lines
    the port seeds from the JAX draws, against JAX find_walls_batched's
    greedy rounds: ok and the remaining pool equal, lines and statistics
    within 1e-10."""
    p = _rp(**kw)
    key = jax.random.PRNGKey(3)
    pts, valid, trial, trial_ok = _wall_inputs(rng, p, key, jnp.float64)
    want = jr.find_walls_batched(pts, valid, key, p, NH)
    got = tr.wall_search_ref(t(pts), t(valid), trial, trial_ok, port(p))
    np.testing.assert_array_equal(n(got[1]), n(want[1]))
    assert n(got[1]).any()
    np.testing.assert_array_equal(n(got[2]), n(want[2]))
    np.testing.assert_allclose(n(got[0]), n(want[0]), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(n(got[3]), n(want[3]), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("kw", WALL_SETS, ids=WALL_IDS)
def test_wall_search_ref_matches_jax_f32(rng, kw):
    """The same at float32: ok and the remaining pool equal; in each
    accepted round the JAX result's feet, angle and statistics lie within
    checks.wall_search_tolerance of the port's f64 run (WALL_FACTOR times
    the farthest of the port's f32 runs, its points reordered 16 ways,
    plus 4 f32 ulps of each quantity's scale)."""
    p = _rp(**dict(kw, dtype=jnp.float32))
    key = jax.random.PRNGKey(3)
    pts, valid, trial, trial_ok = _wall_inputs(rng, p, key, jnp.float32)
    want = jr.find_walls_batched(pts, valid, key, p, NH)
    tp = port(p)
    args = (t(pts), t(valid), trial, trial_ok)
    got = tr.wall_search_ref(*args, tp)
    np.testing.assert_array_equal(n(got[1]), n(want[1]))
    np.testing.assert_array_equal(n(got[2]), n(want[2]))
    g = torch.Generator().manual_seed(0)
    runs = [got] + [C._plain_run(args, tp, torch.randperm(B, generator=g))[
        "res"] for _ in range(16)]
    r64 = tr.wall_search_ref(args[0].double(), args[1], trial.double(),
                             trial_ok, tp)
    q64 = C.wall_search_quantities(r64)
    extent = args[0][args[1]].abs().max().item()
    tol = C.wall_search_tolerance([C.wall_search_quantities(r) for r in runs],
                                  q64, extent)
    gap = C.wall_search_gaps(C.wall_search_quantities(
        tuple(torch.from_numpy(np.asarray(w)) for w in want)), q64)
    acc = torch.from_numpy(n(want[1]))
    assert acc.any()
    assert (gap[acc] <= tol[acc]).all(), (gap[acc], tol[acc])


def _reordered(seed):
    """A stand-in for the kernel on the CPU: the plain version with the
    points in another order, so only the order of its sums differs."""
    def run(pts, valid, trial, trial_ok, params, counts_out=None,
            pools_out=None):
        perm = torch.randperm(pts.shape[0],
                              generator=torch.Generator().manual_seed(seed))
        pools = torch.empty_like(pools_out)
        lines, ok, avail, stats = tr.wall_search_ref(
            pts[perm], valid[perm], trial, trial_ok, params,
            counts_out=counts_out, pools_out=pools)
        pools_out[:, perm] = pools
        back = torch.empty_like(avail)
        back[perm] = avail
        return lines, ok, back, stats
    return run


@pytest.mark.parametrize("setting,seed,B,NH", [
    ("flagship", 0, 1024, 64), ("flagship", 1, 1000, 7),
    ("large_world", 0, 1024, 64), ("large_world", 2, 1024, 64),
    ("large_world", 1, 1000, 7)])
def test_wall_search_compare_accepts_reordered_sums(setting, seed, B, NH):
    """checks.wall_search_compare, the on-card check of the wall-search
    kernel, passes a stand-in that differs from the plain version only in
    the order of its sums (strict at the flagship settings; at
    large_world's a divergent round is accepted only at a decision within
    the f32 rounding band, and listed)."""
    args, params = C.wall_search_case(seed, B, NH, setting, "cpu")
    res = C.wall_search_compare(args, params, setting == "flagship",
                                kernel=_reordered(seed + 100))
    assert res["failures"] == []
    assert res["compared"] and res["accepted"] > 0


@pytest.mark.parametrize("fault", ["line", "stats", "pool", "counts"])
@pytest.mark.parametrize("setting", ["flagship", "large_world"])
def test_wall_search_compare_rejects_a_wrong_kernel(setting, fault):
    """A stand-in kernel with one fault — a line tilted by 1e-4 rad, a
    statistic off by 1e-3 of itself, one point of the pool flipped far from
    every cut, one count changed — fails the check."""
    args, params = C.wall_search_case(0, 1024, 64, setting, "cpu")
    good = _reordered(7)
    plain = C._plain_run(args, params)
    near = {x[1] for r in range(params.wall_search_timeout)
            for x in C._near_cuts(plain, [], r)}

    def bad(pts, valid, trial, trial_ok, params, counts_out=None,
            pools_out=None):
        lines, ok, avail, stats = good(pts, valid, trial, trial_ok, params,
                                       counts_out=counts_out,
                                       pools_out=pools_out)
        r0 = int(torch.nonzero(ok)[0])
        if fault == "line":
            m = torch.tan(torch.atan(lines[r0, 0].double()) + 1e-4)
            lines[r0, 0] = m.float()
        elif fault == "stats":
            stats[r0, 1] *= 1.001
        elif fault == "pool":
            i = next(i for i in range(pts.shape[0]) if i not in near)
            avail[i] = ~avail[i]
            pools_out[r0:, i] = ~pools_out[r0:, i]
        else:
            counts_out[params.wall_search_timeout, 0] += 1
        return lines, ok, avail, stats

    res = C.wall_search_compare(args, params, setting == "flagship",
                                kernel=bad)
    assert res["failures"], res
