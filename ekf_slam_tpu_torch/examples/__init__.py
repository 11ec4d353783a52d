"""Runnable demos of the port, counterparts of the repository's
``examples/`` scripts of the same names.  Each runs as
``python -m ekf_slam_tpu_torch.examples.<name>`` on the card, or on the
CPU with ``--device cpu``."""
