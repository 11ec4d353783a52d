"""The port's examples (ekf_slam_tpu_torch/examples/) stay runnable: each
run in-process as ``python -m ekf_slam_tpu_torch.examples.<name>
--device cpu``, at the arguments and with the markers of
tests/test_examples.py."""
import os
import runpy
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def run_example(name, argv):
    old = sys.argv
    sys.argv = [name] + argv + ["--device", "cpu"]
    try:
        runpy.run_module(f"ekf_slam_tpu_torch.examples.{name}",
                         run_name="__main__", alter_sys=True)
    finally:
        sys.argv = old


def test_run_sim_slam_example(tmp_path, capsys):
    run_example("run_sim_slam", ["--ticks", "40", "--frames",
                                 str(tmp_path), "--metrics",
                                 str(tmp_path / "m.jsonl")])
    out = capsys.readouterr().out
    assert "ATE slam=" in out and "P health: finite=True" in out
    assert os.path.getsize(tmp_path / "final.png") > 5000
    with open(tmp_path / "m.jsonl") as fh:
        assert len(fh.readlines()) == 40


def test_occupancy_mapping_example(capsys):
    run_example("occupancy_mapping", ["--ticks", "40"])
    out = capsys.readouterr().out
    assert "occupied=" in out and "free=" in out


def test_live_view_example(tmp_path, capsys):
    gif = str(tmp_path / "live.gif")
    with pytest.raises(SystemExit) as e:
        run_example("live_view", ["--ticks", "12", "--gif", gif,
                                  "--every", "3"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "live view: 4 frames" in out
    assert os.path.getsize(gif) > 1000       # a real multi-frame GIF
