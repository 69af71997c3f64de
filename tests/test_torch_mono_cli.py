"""`python -m libviso_torch.cli mono` on the CPU.

A folder of generated frames (tests/test_mono.py's sequence, PNG) and its
K: the subcommand prints the JAX CLI's JSON keys (libviso_tpu/cli.py,
``_cmd_mono``: frames, solved, fps, poses, note) and the port's
``device``, and writes the KITTI-format poses.  The reference's CBT_HOME
contract and a 3x4 calibration file are read as the JAX CLI reads them
(the Sim(3) back-end's flags: tests/test_torch_loop_cli.py).  The full-width mono configuration runs at about a second a frame
on one CPU core, so the runs are 3 frames long.
"""

import json

import numpy as np
import pytest
from PIL import Image

from libviso_torch import cli
from libviso_tpu.synthetic import generate_sequence

JAX_KEYS = {"frames", "solved", "fps", "poses", "note"}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("mono")
    seq = generate_sequence(num_frames=3, num_points=600, seed=13, width=416,
                            height=160, speed=0.6, yaw_rate=0.01)
    for i, (left, _) in enumerate(seq.frames):
        Image.fromarray(left.astype(np.uint8)).save(root / f"{i:06d}.png")
        Image.fromarray(left.astype(np.uint8)).save(
            root / f"img-{i + 1:04d}.jpg", quality=95)
    np.savetxt(root / "K.txt", seq.P1[:, :3])
    np.savetxt(root / "calib.txt", seq.P1.reshape(1, 12))   # a 3x4 P row
    return root


def _mono(capsys, *argv):
    cli.main(["mono", "--device", "cpu", *argv])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_mono_on_cpu(folder, capsys):
    out = _mono(capsys, "--image-mask", str(folder / "%06d.png"), "--calib",
                str(folder / "K.txt"), "--out", str(folder / "poses.txt"))
    assert set(out) == JAX_KEYS | {"device"}
    assert out["frames"] == 3 and out["solved"] == 2
    assert out["device"] == "cpu" and "one global scale" in out["note"]
    rows = np.loadtxt(out["poses"])
    assert rows.shape == (3, 12) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[0], np.eye(4)[:3].reshape(-1))


def test_cli_mono_cbt_home_contract(folder, capsys, monkeypatch):
    """With CBT_HOME and no flags: $CBT_HOME/img-%04d.jpg from frame 1 and
    $CBT_HOME/calib.txt (here a 3x4 P, whose left 3x3 is K)."""
    monkeypatch.setenv("CBT_HOME", str(folder))
    out = _mono(capsys, "--no-scale", "--method", "8pt")
    assert out["frames"] == 3 and out["solved"] == 2
    assert out["poses"] is None and "scale-ambiguous" in out["note"]


def test_cli_mono_needs_images_and_calibration(monkeypatch):
    monkeypatch.delenv("CBT_HOME", raising=False)
    with pytest.raises(SystemExit):
        cli.main(["mono", "--device", "cpu"])
