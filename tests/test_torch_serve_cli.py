"""``cli serve`` of the port on the CPU, on a mini KITTI tree of two
sequences: lockstep and ``--pool 2`` write KITTI-format poses and a health
block for each sequence, and the requests the JAX CLI refuses are refused.
"""

import json

import numpy as np
import pytest

from libviso_torch import cli
from tests.test_torch_pipeline import _mini_kitti


@pytest.fixture(scope="module")
def kitti_home(tmp_path_factory):
    """Two mini KITTI sequences, 77 and 78, of the pipeline test's tree."""
    root = tmp_path_factory.mktemp("kitti")
    _mini_kitti(root)
    (root / "sequences" / "77").rename(root / "sequences" / "78")
    _mini_kitti(root)
    return root


@pytest.mark.parametrize("pool", ["0", "2"])
def test_cli_serve_on_cpu(kitti_home, capsys, pool):
    cli.main(["serve", f"sha{pool}", "77,78", "--kitti-home",
              str(kitti_home), "--device", "cpu", "--metric", "l1",
              "--backend", "fused", "--end", "1", "--pool", pool])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["streams"] == 2 and out["aggregate_fps"] > 0
    assert out.get("pool", 0) == int(pool)
    for seq in out["sequences"]:
        assert seq["frames"] == 2 and seq["solved"] == 1
        assert seq["health"]["failed_frames"] == 0
        rows = np.loadtxt(seq["poses"])
        assert rows.shape == (2, 12)
        np.testing.assert_allclose(rows[0], np.eye(4)[:3].reshape(-1))


@pytest.mark.parametrize("argv,error", [
    (["--metric", "l2", "--backend", "fused"], ValueError),
    (["--backend", "sweep"], ValueError),        # the default metric is l2
])
def test_cli_serve_rejects(kitti_home, argv, error):
    with pytest.raises(error):
        cli.main(["serve", "sha", "77,78", "--kitti-home", str(kitti_home),
                  "--device", "cpu", *argv])


def test_cli_serve_l2q8(kitti_home, capsys):
    """Serving under metric 'l2q8' (which used to be refused)."""
    cli.main(["serve", "sha", "77,78", "--kitti-home", str(kitti_home),
              "--device", "cpu", "--metric", "l2q8", "--end", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["streams"] == 2
    for seq in out["sequences"]:
        assert seq["frames"] == 2 and seq["solved"] == 1


@pytest.mark.parametrize("argv", [
    ["77"], ["77,78", "--chunk", "2"],
    ["77,78", "--pool", "2", "--checkpoint-every", "2"]])
def test_cli_serve_exits_on_bad_requests(kitti_home, argv):
    with pytest.raises(SystemExit):
        cli.main(["serve", "sha", *argv, "--kitti-home", str(kitti_home),
                  "--device", "cpu"])


def test_cli_serve_checkpoint_resumes(kitti_home, capsys):
    """A serving run cut by --end and resumed with the full range equals
    the uninterrupted one; the second run computes only the new frames."""
    base = ["serve", "--kitti-home", str(kitti_home), "--device", "cpu",
            "--metric", "l1", "--backend", "sweep"]

    def run(sha, *extra):
        cli.main([base[0], sha, "77,78", *base[1:], *extra])
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    whole = run("whole", "--end", "3")
    ck = kitti_home / "results" / "_serve" / "cut" / "checkpoints"
    # the scope names the range, so the cut run is one with fewer frames on
    # disk, not another --end: hide the last two frames while it runs
    hidden = []
    for seq in ("77", "78"):
        for cam in ("image_0", "image_1"):
            for i in (2, 3, 4, 5):
                f = kitti_home / "sequences" / seq / cam / f"{i:06d}.png"
                f.rename(f.with_suffix(".hid"))
                hidden.append(f)
    try:
        cut = run("cut", "--end", "3", "--checkpoint-every", "2")
    finally:
        for f in hidden:
            f.with_suffix(".hid").rename(f)
    assert [s["frames"] for s in cut["sequences"]] == [2, 2]
    assert sorted(p.name for p in ck.iterdir()) == ["ckpt_00000002.npz"]
    resumed = run("cut", "--end", "3", "--checkpoint-every", "2")
    for a, b in zip(resumed["sequences"], whole["sequences"]):
        assert a["frames"] == b["frames"] == 4 and a["solved"] == b["solved"]
        assert a["health"] == b["health"]
        np.testing.assert_array_equal(np.loadtxt(a["poses"]),
                                      np.loadtxt(b["poses"]))
    with pytest.raises(ValueError, match="fingerprint"):
        run("cut", "--end", "3", "--checkpoint-every", "2", "--seed", "4")
