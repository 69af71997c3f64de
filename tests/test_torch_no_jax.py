"""libviso_torch imports neither JAX nor the JAX package.

An AST scan of the sources: a ``sys.modules`` check would prove nothing
where the interpreter's site configuration imports jax at start-up.
"""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "libviso_torch"
FORBIDDEN = ("jax", "jaxlib", "libviso_tpu")
SOURCES = sorted(PKG.rglob("*.py"))


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_package_has_sources():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES}
    assert {"cli.py", "pipeline/stereo.py", "pipeline/multistream.py",
            "pipeline/batched.py", "ops/cuda_matching.py",
            "ops/fused_matching.py", "ops/pyramid.py", "synthetic_world.py",
            "utils/checkpoint.py", "utils/debug_viz.py", "pipeline/mono.py",
            "geometry/essential.py", "geometry/five_point.py",
            "utils/stats.py", "geometry/sim3.py", "geometry/procrustes.py",
            "solvers/pose_graph.py", "solvers/pose_graph_sim3.py",
            "ops/structural.py", "pipeline/loop.py",
            "pipeline/mono_loop.py", "solvers/bundle_adjust.py",
            "pipeline/refine.py", "pipeline/windowed.py",
            "pipeline/ba_loop.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/distributed.py",
            "parallel/odometry.py", "parallel/tp_matching.py",
            "parallel/pp_odometry.py", "parallel/ba_sharding.py",
            "utils/profiling.py", "native/__init__.py",
            "native/build.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name", ["chip_smoke.py",
                                  "tests/test_torch_cuda.py",
                                  "tools/soak_torch.py",
                                  "tools/threefry.py", "bench_torch.py",
                                  "tools/profile_torch_step.py",
                                  "tools/route_launches.py"])
def test_card_side_scripts_import_no_jax(name):
    """What runs on the card's machine, which has no JAX."""
    bad = [m for m in _imported_modules(PKG.parent / name)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{name} imports {bad}"


def test_bench_torch_imports_only_the_port():
    """bench_torch.py keeps its own copy of bench.py's baselines: it
    imports neither bench.py nor JAX, and of this repository only
    libviso_torch."""
    mods = {m.split(".")[0]
            for m in _imported_modules(PKG.parent / "bench_torch.py")}
    assert not mods & {*FORBIDDEN, "bench", "tools", "tests"}, mods
    assert "libviso_torch" in mods
