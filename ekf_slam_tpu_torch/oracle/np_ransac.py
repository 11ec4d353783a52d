"""NumPy oracle for the RANSAC candidate-table semantics.

List-based, mutation-style mirror of getOutputLandmarkListAndObservedLandmarkList
+ updateLandmarkList (RANSAC.m:234-373), quirks included, driven by an
explicit candidate list so it is deterministic (the random wall search is
tested separately/statistically).  Used to verify the masked fixed-capacity
table in ops/ransac.py.

The port's copy of ekf_slam_tpu/oracle/np_ransac.py (numpy only; the port
imports nothing of the JAX package).
"""
from __future__ import annotations

import numpy as np


class NpLandmarkTable:
    def __init__(self, promote_count=10, assoc_dist=0.5, freshness=50):
        self.entries = []  # dicts: loc, observe, index, fresh
        self.promote_count = promote_count
        self.assoc_dist = assoc_dist
        self.freshness = freshness

    def writeback(self, state_x, last_only=True):
        """RANSAC.m:336-373 — copy filter estimates into the table.
        Reference quirk: only the last state landmark is written back."""
        n = (len(state_x) - 3) // 2
        if n == 0 or not self.entries:
            return
        targets = [n] if last_only else range(1, n + 1)
        for ii in targets:
            for e in self.entries:
                if e["index"] == ii:
                    e["loc"] = np.array(
                        [state_x[3 + 2 * (ii - 1)], state_x[4 + 2 * (ii - 1)]])
                    break

    def update(self, cands, pose):
        """RANSAC.m:234-334 for an explicit candidate list.

        Returns observed rows [dist, ang_deg, index] (+ parallel locs)."""
        observed, obs_locs = [], []
        if not self.entries and len(cands):
            # empty table: seed first candidate only (RANSAC.m:236-241)
            self.entries.append(dict(loc=np.asarray(cands[0], float),
                                     observe=1, index=0,
                                     fresh=self.freshness))
        elif len(cands):
            for cand in cands:
                cand = np.asarray(cand, float)
                flag = False
                for e in self.entries:
                    d = np.linalg.norm(cand - e["loc"])
                    if d < self.assoc_dist:   # no break: all matches count
                        e["observe"] += 1
                        flag = True
                        if (e["observe"] > self.promote_count
                                and e["index"] == 0):
                            e["index"] = max(x["index"]
                                             for x in self.entries) + 1
                        if e["index"] != 0:
                            e["loc"] = cand.copy()
                            delta = cand - np.asarray(pose[:2], float)
                            dist = np.linalg.norm(delta)
                            ang = np.rad2deg(np.arctan2(delta[1], delta[0]))
                            ang = np.mod(ang - pose[2], 360.0)
                            if e["index"] not in [r[2] for r in observed]:
                                observed.append([dist, ang, e["index"]])
                                obs_locs.append(cand.copy())
                if not flag:
                    self.entries.append(dict(loc=cand.copy(), observe=1,
                                             index=0, fresh=self.freshness))
        if len(cands):
            # decay unpromoted entries (RANSAC.m:321-331)
            kept = []
            for e in self.entries:
                if e["index"] == 0:
                    e["fresh"] -= 1
                    if e["fresh"] == 0:
                        continue
                kept.append(e)
            self.entries = kept
        return np.array(observed).reshape(-1, 3), np.array(
            obs_locs).reshape(-1, 2)
