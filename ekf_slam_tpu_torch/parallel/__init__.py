"""The submap and fleet layer (counterpart of ekf_slam_tpu/parallel/'s
modules that run on one device): the keyframe pose graph, submap SLAM with
trajectory loop closures, the fleet of sessions, the fleet map merge and
concurrent submaps.  The mesh-sharded modules (mesh.py, sharded.py,
shard_update.py) are not ported yet."""
