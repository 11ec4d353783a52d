"""The NumPy oracles, the port's own copies of ekf_slam_tpu/oracle/ (the
port imports nothing of the JAX package): NumpyEKFSLAM, the dense
rank-growing filter the benchmark's ``vs_baseline`` times, and
NpLandmarkTable, the list mirror of the RANSAC candidate table."""
