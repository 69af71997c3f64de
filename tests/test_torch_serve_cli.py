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
    (["--checkpoint-every", "2"], NotImplementedError),
])
def test_cli_serve_rejects(kitti_home, argv, error):
    with pytest.raises(error):
        cli.main(["serve", "sha", "77,78", "--kitti-home", str(kitti_home),
                  "--device", "cpu", *argv])


@pytest.mark.parametrize("argv", [["77"], ["77,78", "--chunk", "2"]])
def test_cli_serve_exits_on_bad_requests(kitti_home, argv):
    with pytest.raises(SystemExit):
        cli.main(["serve", "sha", *argv, "--kitti-home", str(kitti_home),
                  "--device", "cpu"])
