"""ekf_slam_tpu_torch's scan logs (io/scanlog.py) and socket feed
(io/socket_feed.py) against ekf_slam_tpu's, on the CPU.

Scan logs: each of the port's codecs (the C++ one, built into the port's
own build directory, and numpy) writes the bytes the JAX package writes,
reads the JAX package's files, and rejects a bad header; a log replayed
through the port's session gives the offline run on the same arrays.
Socket feed: the wire format is the JAX package's, so the port's feeder
feeds the JAX receiver and the JAX feeder the port's receiver, frame for
frame; the port's feeder into its receiver into its streaming session
gives the offline run; a bad magic is rejected; the C++ feeder replays a
log written by the port's codec.  Every feeder runs in a daemon thread
(or, for the C++ feeder, a child process), and every wait has its limit:
the ready event, the join, and the socket timeout on both ends."""
import socket
import subprocess
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.io import scanlog as jlog
from ekf_slam_tpu.io import socket_feed as jfeed
from ekf_slam_tpu.sim import world as jw
from ekf_slam_tpu_torch import SlamSession as TSession
from ekf_slam_tpu_torch.io import native as tnative
from ekf_slam_tpu_torch.io import scanlog as tlog
from ekf_slam_tpu_torch.io import socket_feed as tfeed
from ekf_slam_tpu_torch.io.stream import StreamingSlamSession as TStream

from torch_parity_helpers import port

WAIT = 30.0          # seconds: every wait's limit


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def streams(rng):
    T, B = 40, 360
    odom = rng.normal(0, 1, (T, 3)).astype(np.float32)
    ranges = rng.uniform(0.1, 8.0, (T, B)).astype(np.float32)
    ranges[rng.random((T, B)) < 0.1] = np.nan
    return odom, ranges


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -- scan logs ---------------------------------------------------------------

@pytest.mark.parametrize("jax_native", [True, False])
@pytest.mark.parametrize("native", [True, False])
def test_scanlog_bytes_match_jax(tmp_path, streams, native, jax_native):
    """Each port codec writes the bytes each JAX codec writes, and reads
    them back exactly (NaN where there was no return)."""
    odom, ranges = streams
    mine, theirs = str(tmp_path / "port.eksl"), str(tmp_path / "jax.eksl")
    tlog.write(mine, odom, ranges, native=native)
    jlog.write(theirs, odom, ranges, native=jax_native)
    assert _bytes(mine) == _bytes(theirs)
    assert tlog.info(mine, native=native) == (40, 360)
    o2, r2 = tlog.read(mine, native=native)
    np.testing.assert_array_equal(o2, odom)
    np.testing.assert_array_equal(r2, ranges)
    assert o2.dtype == r2.dtype == np.float32


@pytest.mark.parametrize("native", [True, False])
def test_scanlog_reads_jax_files(tmp_path, streams, native):
    """A log the JAX package wrote (f64 input, stored as f32) reads back
    as the JAX reader reads it."""
    odom, ranges = streams
    p = str(tmp_path / "jax.eksl")
    jlog.write(p, odom.astype(np.float64), ranges.astype(np.float64))
    got, want = tlog.read(p, native=native), jlog.read(p)
    assert tlog.info(p, native=native) == jlog.info(p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("junk", [b"NOPE" + b"\0" * 28,
                                  b"EKSL" + b"\x02\0\0\0" + b"\0" * 24,
                                  b"EKS"])
def test_scanlog_bad_header_rejected(tmp_path, native, junk):
    """A wrong magic, a wrong version and a short file raise IOError from
    both codecs."""
    p = str(tmp_path / "junk.eksl")
    with open(p, "wb") as f:
        f.write(junk)
    with pytest.raises(IOError):
        tlog.info(p, native=native)
    with pytest.raises(IOError):
        tlog.read(p, native=native)


@pytest.mark.parametrize("native", [True, False])
def test_scanlog_truncated_payload_rejected(tmp_path, streams, native):
    odom, ranges = streams
    p = str(tmp_path / "cut.eksl")
    tlog.write(p, odom, ranges)
    with open(p, "r+b") as f:
        f.truncate(16 + 4 * 100)
    with pytest.raises(IOError):
        tlog.read(p, native=native)


def test_scanlog_native_flag(tmp_path, streams, monkeypatch):
    """The C++ codec is built into the port's own build directory; with
    it unavailable, native=True raises and native=None writes the same
    bytes through numpy."""
    assert tlog._load_native() is not None
    lib = tnative.build("scanlog.cc", shared=True)
    assert lib.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    odom, ranges = streams
    want = str(tmp_path / "want.eksl")
    jlog.write(want, odom, ranges, native=False)
    monkeypatch.setattr(tlog, "_load_native", lambda: None)
    with pytest.raises(RuntimeError, match="native codec unavailable"):
        tlog.write(str(tmp_path / "x.eksl"), odom, ranges, native=True)
    got = str(tmp_path / "got.eksl")
    tlog.write(got, odom, ranges)
    assert _bytes(got) == _bytes(want)


def test_scanlog_rejects_bad_shapes(tmp_path):
    with pytest.raises(ValueError):
        tlog.write(str(tmp_path / "x.eksl"), np.zeros((4, 2)),
                   np.zeros((4, 8)))


T, B, NH, SEED = 30, 256, 16, 1


@pytest.fixture(scope="module")
def traj():
    """A 30-tick loop in the 8 m × 6 m room from the JAX simulator, as
    f64 numpy: odometry, ranges, beam angles."""
    cfg = jc.SimConfig(n_beams=B, max_range=12.0, range_noise_std=0.01,
                       odom_xy_noise_std=0.0005, odom_theta_noise_std=0.02)
    tr = jw.simulate(jw.rectangle_room(4.0, 3.0),
                     jw.circle_controls(T, 0.05, 3.0), cfg,
                     jax.random.PRNGKey(0))
    return np.array(tr.odom), np.array(tr.ranges), np.array(tr.beam_angles)


def _session():
    ep = jc.EKFParams(capacity=16, max_obs=8, ref_compat=False,
                      update_mode="batched", dtype=jnp.float64,
                      pht_mode="rows", correction="syrk")
    rp = jc.RansacParams(line_consensus=20, bearing_window_deg=20.0,
                         sample_points=8, wall_search_timeout=4,
                         table_capacity=32, promote_count=2,
                         ref_compat=False, n_hypotheses=NH,
                         dtype=jnp.float64)
    return TSession(ekf_params=port(ep), ransac_params=port(rp), seed=SEED,
                    device="cpu")


@pytest.mark.parametrize("native", [True, False])
def test_scanlog_replay_through_session_equals_run(tmp_path, traj, native):
    """Record a simulated run, replay it through the port's session: the
    outputs equal the session's run on the log's own (f32) arrays."""
    odom, ranges, beams = traj
    p = str(tmp_path / "session.eksl")
    tlog.write(p, odom, ranges, native=native)
    lo, lr = tlog.read(p, native=native)
    _, replay = _session().run(lo, lr, beams)
    _, direct = _session().run(odom.astype(np.float32),
                               ranges.astype(np.float32), beams)
    assert torch.equal(replay.pose, direct.pose)
    assert torch.equal(replay.n_active, direct.n_active)
    assert int(replay.n_active[-1]) >= 3


# -- socket feed --------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _feeder_thread(target, *args, **kw):
    """``target(port, *args, ready_event=..., **kw)`` in a daemon thread,
    started and listening: (thread, port, errors raised in it)."""
    port_ = _free_port()
    ready, errors = threading.Event(), []

    def run():
        try:
            target(port_, *args, ready_event=ready, **kw)
        except Exception as e:            # reported by the test
            errors.append(e)
            ready.set()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(WAIT), "feeder never came up"
    assert not errors, errors
    return th, port_, errors


def _join(th, errors):
    th.join(WAIT)
    assert not th.is_alive(), "feeder did not finish"
    assert not errors, errors


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_port_feeder_into_jax_receiver(streams, dtype):
    odom, ranges = (a.astype(dtype) for a in streams)
    th, port_, errors = _feeder_thread(tfeed.serve_trajectory, odom, ranges,
                                       timeout=WAIT)
    src = jfeed.SocketScanSource("127.0.0.1", port_, connect_timeout=WAIT)
    src._sock.settimeout(WAIT)
    got = list(src)
    _join(th, errors)
    assert src.n_beams == ranges.shape[1] and src.dtype == dtype
    np.testing.assert_array_equal(np.stack([o for o, _ in got]), odom)
    np.testing.assert_array_equal(np.stack([r for _, r in got]), ranges)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jax_feeder_into_port_receiver(streams, dtype):
    odom, ranges = (a.astype(dtype) for a in streams)
    th, port_, errors = _feeder_thread(jfeed.serve_trajectory, odom, ranges)
    src = tfeed.SocketScanSource("127.0.0.1", port_, connect_timeout=WAIT,
                                 timeout=WAIT)
    got = list(src)
    _join(th, errors)
    assert src.n_beams == ranges.shape[1] and src.dtype == dtype
    assert all(o.dtype == dtype and r.dtype == dtype for o, r in got)
    np.testing.assert_array_equal(np.stack([o for o, _ in got]), odom)
    np.testing.assert_array_equal(np.stack([r for _, r in got]), ranges)


def test_socket_feed_into_stream_equals_offline_run(traj):
    """The port's feeder → its receiver → its streaming session (window 8)
    gives the offline run tick for tick, bit for bit."""
    odom, ranges, beams = traj
    th, port_, errors = _feeder_thread(tfeed.serve_trajectory, odom, ranges,
                                       timeout=WAIT)
    src = tfeed.SocketScanSource("127.0.0.1", port_, connect_timeout=WAIT,
                                 timeout=WAIT)
    stream = TStream(_session(), n_beams=src.n_beams, beam_angles=beams,
                     window=8, first_odom=odom[0])
    got = []
    for od, rg in src:
        got.extend(stream.push(od, rg))
    got.extend(stream.flush())
    _join(th, errors)
    _, off = _session().run(odom, ranges, beams)
    assert len(got) == T
    np.testing.assert_array_equal(np.stack([o.pose for o in got]),
                                  off.pose.numpy())
    np.testing.assert_array_equal(np.stack([o.n_active for o in got]),
                                  off.n_active.numpy())


def _bogus_server(port_, payload, ready_event):
    with socket.socket() as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port_))
        srv.listen(1)
        srv.settimeout(WAIT)
        ready_event.set()
        conn, _ = srv.accept()
        with conn:
            conn.sendall(payload)
            time.sleep(1.0)           # hold the connection open


def test_socket_source_rejects_bad_magic():
    th, port_, errors = _feeder_thread(_bogus_server, b"NOPE" + bytes(5))
    with pytest.raises(OSError, match="EKSL"):
        tfeed.SocketScanSource("127.0.0.1", port_, connect_timeout=WAIT,
                               timeout=WAIT)
    _join(th, errors)


def test_socket_source_rejects_bad_tag():
    hdr = tfeed._HDR.pack(tfeed.MAGIC, 2, ord("f"))
    th, port_, errors = _feeder_thread(_bogus_server,
                                       hdr + tfeed._TAG.pack(7))
    src = tfeed.SocketScanSource("127.0.0.1", port_, connect_timeout=WAIT,
                                 timeout=WAIT)
    with pytest.raises(OSError, match="tag 7"):
        next(src)
    _join(th, errors)


def test_socket_source_times_out_on_a_stalled_feed():
    """A feed that sends its header and then nothing: with a receive
    timeout the next tick raises instead of waiting for ever."""
    hdr = tfeed._HDR.pack(tfeed.MAGIC, 4, ord("f"))
    th, port_, errors = _feeder_thread(_bogus_server, hdr)
    src = tfeed.SocketScanSource("127.0.0.1", port_, connect_timeout=WAIT,
                                 timeout=0.2)
    assert src.n_beams == 4
    with pytest.raises(TimeoutError):
        next(src)
    _join(th, errors)


def test_feeder_times_out_without_a_client_and_frees_its_port(streams):
    """With no client the feeder raises after its timeout and closes its
    socket: the port can be listened on again at once."""
    odom, ranges = streams
    port_ = _free_port()
    with pytest.raises(TimeoutError):
        tfeed.serve_trajectory(port_, odom, ranges, timeout=0.2)
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port_))
        s.listen(1)


def test_native_feeder_streams_port_scanlog(tmp_path):
    """The C++ feeder (native/scan_feeder.cc, built into the port's build
    directory) replays a log written by the port's C++ codec; the port's
    receiver gets every tick exactly, across the process boundary."""
    binary = tfeed.native_feeder_path()
    if binary is None:
        pytest.skip("no C++ toolchain")
    assert binary.startswith(str(tnative.BUILD_DIR))
    rng = np.random.default_rng(3)
    Tn, Bn = 12, 90
    odom = rng.normal(size=(Tn, 3)).astype(np.float32)
    ranges = rng.uniform(0.5, 10.0, (Tn, Bn)).astype(np.float32)
    ranges[2, 5] = np.nan
    path = str(tmp_path / "s.ekslog")
    tlog.write(path, odom, ranges, native=True)
    port_ = _free_port()
    proc = subprocess.Popen([binary, path, str(port_)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + WAIT
        while True:
            try:
                src = tfeed.SocketScanSource("127.0.0.1", port_,
                                             connect_timeout=1.0,
                                             timeout=WAIT)
                break
            except ConnectionRefusedError:
                assert time.monotonic() < deadline, "feeder never listened"
                time.sleep(0.05)
        assert src.n_beams == Bn and src.dtype == np.float32
        got = list(src)
        assert proc.wait(timeout=WAIT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
    assert len(got) == Tn
    np.testing.assert_array_equal(np.stack([o for o, _ in got]), odom)
    np.testing.assert_array_equal(np.stack([r for _, r in got]), ranges)
