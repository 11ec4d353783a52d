"""Live sensor feed over a process boundary (counterpart of
ekf_slam_tpu/io/socket_feed.py): the reference's ROS seam (``rosinit`` +
``rossubscriber('/scan'|'/odom')`` + blocking ``receive``, SLAM.m:23-24,
73-74) as a length-tagged binary protocol over TCP, with a feeder
(``serve_trajectory``, the robot's side) and a receiver
(``SocketScanSource``) that feeds the streaming session:

    src = SocketScanSource("127.0.0.1", port)            # blocks: connect
    stream = StreamingSlamSession(sess, n_beams=src.n_beams, ...)
    for odom, ranges in src:                             # blocking receive
        outs = stream.push(odom, ranges)

Wire format (little-endian), byte for byte the JAX package's, so either
package's feeder feeds either package's receiver:
    header   : magic b"EKSL" | u32 n_beams | u8 dtype ('f'=f32, 'd'=f64)
    per tick : u32 tag=1 | (3+n_beams) floats (odom pose, then ranges)
    shutdown : u32 tag=2

``native_feeder_path`` builds the C++ feeder (native/scan_feeder.cc),
which replays a scan log (io/scanlog.py) over the same protocol.
"""
from __future__ import annotations

import socket
import struct
import subprocess
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from . import native as _native

MAGIC = b"EKSL"
_HDR = struct.Struct("<4sIB")
_TAG = struct.Struct("<I")
TAG_TICK = 1
TAG_END = 2


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"scan feed closed mid-message ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def serve_trajectory(port: int, odom: np.ndarray, ranges: np.ndarray,
                     host: str = "127.0.0.1",
                     rate_hz: Optional[float] = None,
                     ready_event=None,
                     timeout: Optional[float] = None) -> None:
    """Feeder ("robot") side: listen, accept one client, stream every
    tick, send the end tag, close.  ``rate_hz`` throttles to a sensor
    cadence (None = as fast as the socket takes them).  Runs in its own
    process or thread; ``ready_event.set()`` fires once listening.
    ``timeout`` (seconds, None = wait for ever) bounds the wait for the
    client and each send; the sockets are closed on any error."""
    odom = np.asarray(odom)
    ranges = np.asarray(ranges)
    if (odom.ndim != 2 or odom.shape[1] != 3 or ranges.ndim != 2
            or ranges.shape[0] != odom.shape[0]):
        raise ValueError(f"odom {odom.shape} and ranges {ranges.shape}: "
                         "expected [T,3] and [T,B]")
    dt = np.float64 if odom.dtype == np.float64 else np.float32
    dtype_char = b"d" if dt == np.float64 else b"f"

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        srv.settimeout(timeout)
        if ready_event is not None:
            ready_event.set()
        conn, _ = srv.accept()
        with conn:
            conn.settimeout(timeout)
            conn.sendall(_HDR.pack(MAGIC, ranges.shape[1], dtype_char[0]))
            period = (1.0 / rate_hz) if rate_hz else 0.0
            nxt = time.perf_counter()
            for t in range(odom.shape[0]):
                if period:
                    nxt += period
                    lag = nxt - time.perf_counter()
                    if lag > 0:
                        time.sleep(lag)
                frame = np.concatenate(
                    [odom[t].astype(dt), ranges[t].astype(dt)])
                conn.sendall(_TAG.pack(TAG_TICK) + frame.tobytes())
            conn.sendall(_TAG.pack(TAG_END))


def native_feeder_path() -> Optional[str]:
    """Build (once) and return the path of the C++ robot-side feeder
    (native/scan_feeder.cc): it replays a scan log over this protocol as
    a standalone program.  None where there is no toolchain.

        python: src = SocketScanSource("127.0.0.1", port)
        shell:  <feeder> session.ekslog <port> [rate_hz]
    """
    try:
        return str(_native.build("scan_feeder.cc", shared=False))
    except (OSError, subprocess.SubprocessError):
        return None


class SocketScanSource:
    """Receiver side of the seam: a blocking per-tick iterator of
    ``(odom_pose f[3], ranges f[B])`` numpy arrays, the ``receive(laser)``/
    ``receive(odom)`` pair of SLAM.m:73-74 as one framed message.
    ``timeout`` (seconds, None = wait for ever, as a live robot's loop
    does) bounds each receive after the connection is made."""

    def __init__(self, host: str, port: int, connect_timeout: float = 30.0,
                 timeout: Optional[float] = None):
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        try:
            self._sock.settimeout(timeout)
            magic, n_beams, dchar = _HDR.unpack(
                _recv_exact(self._sock, _HDR.size))
            if magic != MAGIC:
                raise OSError(f"not an EKSL scan feed (magic {magic!r})")
        except BaseException:
            self._sock.close()
            raise
        self.n_beams = int(n_beams)
        self.dtype = np.float64 if dchar == ord("d") else np.float32
        self._frame_bytes = (3 + self.n_beams) * np.dtype(
            self.dtype).itemsize

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        try:
            tag, = _TAG.unpack(_recv_exact(self._sock, _TAG.size))
            if tag == TAG_END:
                raise StopIteration
            if tag != TAG_TICK:
                raise OSError(f"scan feed protocol error (tag {tag})")
            frame = np.frombuffer(
                _recv_exact(self._sock, self._frame_bytes), dtype=self.dtype)
        except BaseException:
            self._sock.close()
            raise
        return frame[:3].copy(), frame[3:].copy()

    def close(self) -> None:
        self._sock.close()
