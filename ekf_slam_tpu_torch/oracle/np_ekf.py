"""NumPy oracle: a dense, rank-growing EKF-SLAM mirroring the reference's
computational structure, quirks included.

This is the verification target (SURVEY.md §4.2) and the throughput baseline
for bench.py: it does what the MATLAB does — dense F·P·Fᵀ (EKF_SLAM.m:47),
per-landmark Python-loop gating with a full H·P·Hᵀ inside
(Correspondence.m:49-87), dense (I−KH)·P updates (EKF_SLAM_UC.m:146), and
concatenation-based landmark append (EKF_SLAM.m:79,91-97).  It is written in
NumPy from the documented math, not transliterated source.

Angles are degrees throughout; quirks reproduced:
  * motion Jacobian at theta (pre-increment), no pi/180 (EKF_SLAM.m:62-64)
  * bearing innovation not re-wrapped (EKF_SLAM_UC.m:145)
  * append jz built from (dD, dTheta) (EKF_SLAM.m:87-88)
  * signature-only association cost (Correspondence.m:75)

The port's copy of ekf_slam_tpu/oracle/np_ekf.py (numpy only; the port
imports nothing of the JAX package).
"""
from __future__ import annotations

import numpy as np


def _cosd(a):
    return np.cos(np.deg2rad(a))


def _sind(a):
    return np.sin(np.deg2rad(a))


def _atan2d(y, x):
    return np.rad2deg(np.arctan2(y, x))


def _wrap360(a):
    w = np.mod(a, 360.0)
    if np.isscalar(w) or w.ndim == 0:
        return 360.0 if (w == 0.0 and a > 0.0) else w
    w = np.where((w == 0.0) & (a > 0.0), 360.0, w)
    return w


class NumpyEKFSLAM:
    """Dense oracle filter; unknown-correspondence by default.

    Parameters mirror EKF_SLAM_UC.m:12-16 (or EKF_SLAM.m:12-16 for the
    known-correspondence mode)."""

    def __init__(self, c_process=0.2, rc=(0.1, 5.0), s_cost=1e-11,
                 s_thresh=1e9, p0_diag=0.1, association="signature",
                 known_idx_by_counter=True, dtype=np.float64):
        self.C = c_process
        self.rc = rc
        self.s_cost = s_cost
        self.s_thresh = s_thresh
        self.association = association
        self.known_idx_by_counter = known_idx_by_counter
        self.dtype = dtype
        self.x = np.zeros(3, dtype)
        self.P = np.eye(3, dtype=dtype) * p0_diag
        self.s = np.zeros(0, dtype)

    @property
    def n_landmarks(self):
        return (len(self.x) - 3) // 2

    # -- predict ----------------------------------------------------------
    def predict(self, u):
        """EKF_SLAM.m:40-51: Q = W·C·Wᵀ on the pose block; dense F·P·Fᵀ."""
        th = self.x[2]
        dD, dTh = u
        W = np.array([dD * _cosd(th), dD * _sind(th), dTh], self.dtype)
        Q = np.zeros_like(self.P)
        Q[:3, :3] = np.outer(W, W) * self.C

        F = np.eye(len(self.x), dtype=self.dtype)
        F[0, 2] = -dD * _sind(th)
        F[1, 2] = dD * _cosd(th)
        self.x[0] += dD * _cosd(th + dTh)
        self.x[1] += dD * _sind(th + dTh)
        self.x[2] = _wrap360(th + dTh)
        self.P = F @ self.P @ F.T + Q

    # -- append -----------------------------------------------------------
    def append(self, u, R, loc, signature):
        """EKF_SLAM.m:67-98: 'SLAM for Dummies' covariance growth."""
        dD, dTh = u
        n = len(self.P)
        n_lm = self.n_landmarks
        self.s = np.append(self.s, signature)
        self.x = np.append(self.x, [loc[0], loc[1]]).astype(self.dtype)
        th = self.x[2]
        jxr = np.array([[1, 0, -dD * _sind(th)],
                        [0, 1, dD * _cosd(th)]], self.dtype)
        jz = np.array([[_cosd(dTh), -dD * _sind(dTh)],
                       [_sind(dTh), dD * _cosd(dTh)]], self.dtype)
        P = np.zeros((n + 2, n + 2), self.dtype)
        P[:n, :n] = self.P
        P[n:, n:] = jxr @ self.P[:3, :3] @ jxr.T + jz @ R @ jz.T
        P[:3, n:] = self.P[:3, :3] @ jxr.T
        P[n:, :3] = P[:3, n:].T
        for k in range(n_lm):
            c = 3 + 2 * k
            P[n:, c:c + 2] = jxr @ self.P[c:c + 2, :3].T
            P[c:c + 2, n:] = P[n:, c:c + 2].T
        self.P = P

    # -- measurement machinery -------------------------------------------
    def _innovation(self, idx):
        """Correspondence.m:50-63 / EKF_SLAM_UC.m:125-139 blocks for
        landmark idx (0-based): returns (zhat, H dense [2,D])."""
        th = self.x[2]
        c = 3 + 2 * idx
        delta = self.x[c:c + 2] - self.x[:2]
        q = float(delta @ delta)
        sq = np.sqrt(q)
        zhat = np.array([sq, _wrap360(_atan2d(delta[1], delta[0]) - th)],
                        self.dtype)
        H = np.zeros((2, len(self.x)), self.dtype)
        Hp = (1.0 / q) * np.array(
            [[-sq * delta[0], -sq * delta[1], 0, sq * delta[0], sq * delta[1]],
             [delta[1], -delta[0], -q, -delta[1], delta[0]]], self.dtype)
        H[:, :3] = Hp[:, :3]
        H[:, c:c + 2] = Hp[:, 3:]
        return zhat, H

    def correspond(self, z, R):
        """Correspondence.m:28-88: loop over landmarks, full Mahalanobis
        computed, signature cost used.  Returns (is_new, idx 0-based)."""
        is_new, best, best_cost = True, self.n_landmarks, np.inf
        for k in range(self.n_landmarks):
            zhat, H = self._innovation(k)
            Phi = H @ self.P @ H.T + R
            nu = z[:2] - zhat
            position_cost = nu @ np.linalg.inv(Phi) @ nu  # computed, unused
            signature_cost = (z[2] - self.s[k]) ** 2 / self.s_cost
            cost = (position_cost + signature_cost
                    if self.association == "ml" else signature_cost)
            if cost <= self.s_thresh and cost < best_cost:
                is_new, best_cost, best = False, cost, k
        return is_new, best

    def update(self, z, idx, R):
        """EKF_SLAM_UC.m:125-146: dense K = P·Hᵀ·Φ⁻¹, P ← (I−KH)·P."""
        zhat, H = self._innovation(idx)
        Phi = H @ self.P @ H.T + R
        K = self.P @ H.T @ np.linalg.inv(Phi)
        self.x = self.x + K @ (z[:2] - zhat)
        self.P = (np.eye(len(self.x), dtype=self.dtype) - K @ H) @ self.P

    def measure(self, observed, u, loc_by_index):
        """Reference measurement loop (EKF_SLAM_UC.m:102-152).

        ``observed``: rows [range, bearing_deg, index]; ``loc_by_index``:
        dict index -> world-frame landmark position (the extractor table
        lookup at EKF_SLAM_UC.m:113,123)."""
        for ii, z in enumerate(np.atleast_2d(observed)):
            if len(z) == 0:
                continue
            R = np.diag([z[0] * self.rc[0], z[1] * self.rc[1]]).astype(
                self.dtype)
            if self.n_landmarks == 0:
                self.append(u, R, loc_by_index[int(z[2])], z[2])
                continue
            if self.association == "known":
                # EKF_SLAM.m:118-123 path
                if z[2] > self.n_landmarks:
                    self.append(u, R, loc_by_index[int(z[2])], z[2])
                else:
                    idx = ii if self.known_idx_by_counter else int(z[2]) - 1
                    self.update(z, idx, R)
                continue
            is_new, idx = self.correspond(z, R)
            if is_new:
                self.append(u, R, loc_by_index[int(z[2])], z[2])
            else:
                self.update(z, idx, R)
