"""The port's NumPy oracles (ekf_slam_tpu_torch/oracle/, its own copies)
against the JAX package's, and the port's filter and candidate table
against them, on the CPU.

- The copies give outputs equal to the JAX package's oracles, bit for
  bit, on seeded sequences (predict, append, every association mode's
  measure; candidate tables with promotion, decay and write-back).
- The port's sequential filter (models/ekf: predict, append, update,
  measure) is held to the port's NumpyEKFSLAM with the tolerances of
  tests/test_ekf_core.py, and the port's fixed-capacity candidate table
  (ops/ransac.update_table, writeback) to the port's NpLandmarkTable as
  tests/test_ransac.py holds JAX's."""
import numpy as np
import pytest
import torch

from ekf_slam_tpu.oracle.np_ekf import NumpyEKFSLAM as JNumpyEKFSLAM
from ekf_slam_tpu.oracle.np_ransac import NpLandmarkTable as JNpTable
from ekf_slam_tpu_torch import config as tc
from ekf_slam_tpu_torch.models import ekf
from ekf_slam_tpu_torch.ops import ransac
from ekf_slam_tpu_torch.ops.observations import obs_from_rows
from ekf_slam_tpu_torch.oracle.np_ekf import NumpyEKFSLAM
from ekf_slam_tpu_torch.oracle.np_ransac import NpLandmarkTable
from ekf_slam_tpu_torch.state import init_state

PARAMS = tc.ref_compat_uc(capacity=8, dtype=torch.float64)
PAR = tc.RansacParams(table_capacity=16, dtype=torch.float64)
LOCS = {1: np.array([2.0, 0.0]), 2: np.array([0.0, 2.0]),
        3: np.array([-2.0, 1.0]), 4: np.array([1.0, -2.5])}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def tt(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def rows_seen(oracle, seen, rng):
    """Observation rows [range, bearing, index] of landmarks ``seen`` from
    the oracle's pose, with range noise from ``rng``."""
    rows, row_locs = [], []
    for idx in seen:
        d = LOCS[idx] - oracle.x[:2]
        r = np.hypot(*d) + rng.normal(0, 0.01)
        b = np.mod(np.rad2deg(np.arctan2(d[1], d[0])) - oracle.x[2], 360)
        rows.append([r, b, idx])
        row_locs.append(LOCS[idx])
    return rows, row_locs


# -- the copies against the JAX package's oracles ----------------------------

@pytest.mark.parametrize("association", ["signature", "ml", "known"])
def test_numpy_ekf_copy_equals_the_jax_packages(association):
    """12 ticks of predict + measure (append or update per row) from a
    seeded sequence: x, P and the signatures bit-equal."""
    mine = NumpyEKFSLAM(association=association)
    theirs = JNumpyEKFSLAM(association=association)
    rng = np.random.default_rng(21)
    for step in range(12):
        u = np.array([rng.uniform(0, 0.1), rng.uniform(-5, 5)])
        mine.predict(u)
        theirs.predict(u)
        seen = sorted(rng.choice(list(LOCS), size=min(step + 1, 4),
                                 replace=False))
        rows, _ = rows_seen(mine, seen, rng)
        mine.measure(np.array(rows), u, LOCS)
        theirs.measure(np.array(rows), u, LOCS)
        np.testing.assert_array_equal(mine.x, theirs.x)
        np.testing.assert_array_equal(mine.P, theirs.P)
        np.testing.assert_array_equal(mine.s, theirs.s)
    assert mine.n_landmarks == theirs.n_landmarks >= 3


def test_numpy_ekf_copy_helpers_equal():
    from ekf_slam_tpu.oracle import np_ekf as j
    from ekf_slam_tpu_torch.oracle import np_ekf as p
    a = np.array([-720.0, -360.0, -0.0, 0.0, 1e-9, 359.999, 360.0, 725.5])
    for name in ("_cosd", "_sind", "_wrap360"):
        np.testing.assert_array_equal(getattr(p, name)(a),
                                      getattr(j, name)(a))
    for v in (0.0, 360.0, 720.0, -30.0):
        assert p._wrap360(v) == j._wrap360(v)
    np.testing.assert_array_equal(p._atan2d(a, a[::-1]),
                                  j._atan2d(a, a[::-1]))


def _table_sequence(seed, T=40):
    """Candidate lists of a seeded run: a few fixed spots, each seen with
    jitter on most ticks, some ticks empty."""
    rng = np.random.default_rng(seed)
    spots = rng.uniform(-4, 4, (5, 2))
    seq = []
    for _ in range(T):
        k = rng.integers(0, 4)
        pick = rng.choice(5, size=k, replace=False)
        seq.append(spots[pick] + rng.normal(0, 0.05, (k, 2)))
    return seq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_table_copy_equals_the_jax_packages(seed):
    mine = NpLandmarkTable(promote_count=4, assoc_dist=0.5, freshness=6)
    theirs = JNpTable(promote_count=4, assoc_dist=0.5, freshness=6)
    pose = np.array([0.3, -0.2, 40.0])
    x = np.concatenate([pose, np.arange(1.0, 13.0)])
    for t, cands in enumerate(_table_sequence(seed)):
        a, al = mine.update(list(cands), pose)
        b, bl = theirs.update(list(cands), pose)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(al, bl)
        if t % 5 == 4:
            mine.writeback(x, last_only=t % 2 == 0)
            theirs.writeback(x, last_only=t % 2 == 0)
        assert len(mine.entries) == len(theirs.entries)
        for e, f in zip(mine.entries, theirs.entries):
            assert e.keys() == f.keys()
            np.testing.assert_array_equal(e["loc"], f["loc"])
            assert (e["observe"], e["index"], e["fresh"]) == (
                f["observe"], f["index"], f["fresh"])


# -- the port's filter against the port's oracle (tests/test_ekf_core.py) -----

def make_pair(n_landmarks=0, seed=0):
    """A (port state, oracle) pair with identical random contents."""
    rng = np.random.default_rng(seed)
    state = init_state(PARAMS, device="cpu")
    oracle = NumpyEKFSLAM()
    for k in range(n_landmarks):
        u = rng.uniform(-0.2, 0.2, 2)
        loc = rng.uniform(-3, 3, 2)
        R = np.diag(rng.uniform(0.01, 0.1, 2))
        oracle.predict(u)
        oracle.append(u, R, loc, float(k + 1))
        state = ekf.predict(state, tt(u), PARAMS)
        state = ekf.append(state, tt(u), tt(R), tt(loc), float(k + 1),
                           PARAMS)
    return state, oracle


def dense_of(state):
    n = int(state.n_active)
    d = 3 + 2 * n
    return state.x[:d].numpy(), state.P[:d, :d].numpy()


def test_predict_matches_oracle():
    state, oracle = make_pair(3)
    u = np.array([0.15, 7.0])
    state = ekf.predict(state, tt(u), PARAMS)
    oracle.predict(u)
    x, P = dense_of(state)
    np.testing.assert_allclose(x, oracle.x, atol=1e-12)
    np.testing.assert_allclose(P, oracle.P, atol=1e-12)


def test_append_matches_oracle():
    state, oracle = make_pair(2)
    u = np.array([0.1, 5.0])
    R = np.diag([0.02, 0.3])
    loc = np.array([1.5, -2.0])
    state = ekf.append(state, tt(u), tt(R), tt(loc), 3.0, PARAMS)
    oracle.append(u, R, loc, 3.0)
    x, P = dense_of(state)
    np.testing.assert_allclose(x, oracle.x, atol=1e-12)
    np.testing.assert_allclose(P, oracle.P, atol=1e-12)
    assert int(state.n_active) == 3 and float(state.sig[2]) == 3.0


@pytest.mark.parametrize("slot", [0, 1, 2])
def test_update_matches_oracle(slot):
    state, oracle = make_pair(3, seed=4)
    z = np.array([2.0, 133.0, float(slot + 1)])
    R = np.diag([z[0] * 0.1, z[1] * 5.0])
    state = ekf.update(state, tt(z), slot, tt(R), PARAMS)
    oracle.update(z, slot, R)
    x, P = dense_of(state)
    np.testing.assert_allclose(x, oracle.x, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(P, oracle.P, rtol=1e-8, atol=1e-10)


def test_measure_sequence_matches_oracle():
    """The measurement phase (association + append/update chain,
    EKF_SLAM_UC.m:102-152) on a scripted sequence."""
    state, oracle = make_pair(0)
    u = np.array([0.05, 2.0])
    rng = np.random.default_rng(3)
    for step in range(6):
        seen = [i + 1 for i in range(min(step + 1, 3))]
        rows, row_locs = rows_seen(oracle, seen, rng)
        state = ekf.predict(state, tt(u), PARAMS)
        oracle.predict(u)
        obs = obs_from_rows(rows, row_locs, PARAMS.max_obs, torch.float64,
                            device="cpu")
        state = ekf.measure(state, obs, tt(u), PARAMS)
        oracle.measure(np.array(rows), u, LOCS)
    x, P = dense_of(state)
    assert int(state.n_active) == oracle.n_landmarks == 3
    np.testing.assert_allclose(x, oracle.x, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(P, oracle.P, rtol=1e-6, atol=1e-8)


# -- the port's candidate table against the port's oracle (test_ransac.py) ---

def run_both(cand_seq, pose=(0.0, 0.0, 0.0), par=PAR):
    table = ransac.init_table(par, device="cpu")
    oracle = NpLandmarkTable(par.promote_count, par.assoc_dist, par.freshness)
    pose_t = tt(pose)
    outs = []
    for cands in cand_seq:
        cands = np.asarray(cands, float).reshape(-1, 2)
        k = cands.shape[0]
        ct = torch.zeros((max(k, 1), 2), dtype=torch.float64)
        ok = torch.zeros((max(k, 1),), dtype=torch.bool)
        if k:
            ct, ok = tt(cands), torch.ones((k,), dtype=torch.bool)
        obs, table = ransac.update_table(table, ct, ok, pose_t, par,
                                         max_obs=8)
        ref_obs, _ = oracle.update(list(cands), np.asarray(pose))
        outs.append((obs, ref_obs))
    return outs, table, oracle


def check_table_matches(table, oracle):
    used = table.used.numpy()
    ours = sorted(
        (tuple(np.round(table.loc.numpy()[i], 9)), int(table.observe[i]),
         int(table.index[i]), int(table.fresh[i]))
        for i in range(len(used)) if used[i])
    ref = sorted((tuple(np.round(e["loc"], 9)), e["observe"], e["index"],
                  e["fresh"]) for e in oracle.entries)
    assert ours == ref


def check_rows(outs):
    for obs, ref_obs in outs:
        k = int(obs.valid.sum())
        assert k == len(ref_obs)
        if k:
            got = np.stack([obs.rng[:k].numpy(), obs.bearing[:k].numpy(),
                            obs.index[:k].numpy().astype(float)], -1)
            np.testing.assert_allclose(got, ref_obs, atol=1e-9)


def test_table_empty_seed_quirk():
    outs, table, oracle = run_both([[[1.0, 1.0], [5.0, 5.0]]])
    assert int(table.used.sum()) == 1
    check_table_matches(table, oracle)


def test_table_promotion_and_observation():
    outs, table, oracle = run_both([[[2.0, 1.0]]] * 13)
    check_table_matches(table, oracle)
    assert int(table.index.max()) == 1
    check_rows(outs)


def test_table_freshness_decay():
    par = tc.RansacParams(table_capacity=16, freshness=5,
                          dtype=torch.float64)
    outs, table, oracle = run_both([[[1.0, 1.0]]] + [[[9.0, 9.0]]] * 6,
                                   par=par)
    check_table_matches(table, oracle)
    locs = table.loc.numpy()[table.used.numpy()]
    assert not np.any(np.all(np.isclose(locs, [1.0, 1.0]), axis=-1))


def test_table_multi_candidates_and_dedupe():
    a, b, c = [0.0, 2.0], [3.0, 0.0], [-2.0, -2.0]
    seq = [[a]] + [[a, b]] * 6 + [[a, b, c]] * 8 + [[b, a]] * 4
    outs, table, oracle = run_both(seq)
    check_table_matches(table, oracle)
    check_rows(outs)


@pytest.mark.parametrize("seed", [0, 1])
def test_table_seeded_sequence_and_writeback(seed):
    """A seeded sequence at a non-zero pose, then the write-back of the
    last promoted landmark (the reference's quirk) on both."""
    pose = (1.0, -2.0, 35.0)
    outs, table, oracle = run_both(_table_sequence(seed + 5), pose=pose)
    check_table_matches(table, oracle)
    check_rows(outs)
    n = int(table.index.max())
    assert n >= 1
    x = np.concatenate([pose, np.arange(1.0, 1.0 + 2 * n)])
    table = ransac.writeback(table, tt(x), torch.tensor(n, dtype=torch.int32),
                             PAR)
    oracle.writeback(x, last_only=True)
    check_table_matches(table, oracle)
