"""Every symbol that tests/test_parity_surface.py pins on the JAX package
has its counterpart in libviso_torch, under the same module path and name
except where the port renames it (RENAMED).  SURFACE is read from that
file's source, so this test imports no JAX."""

import ast
import importlib
import pathlib

import pytest

# the JAX package's module or symbol -> the port's
RENAMED = {
    "ops.pallas_matching": "ops.cuda_matching",
    "ops.pallas_fused_match": "ops.fused_matching",
    "time_jitted": "time_call",
}


def _surface():
    path = pathlib.Path(__file__).with_name("test_parity_surface.py")
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and \
                [t.id for t in node.targets] == ["SURFACE"]:
            return ast.literal_eval(node.value)
    raise AssertionError("SURFACE not found in test_parity_surface.py")


SURFACE = _surface()


def _counterpart(module, symbol):
    sub = module.removeprefix("libviso_tpu").lstrip(".")
    sub = RENAMED.get(sub, sub)
    return ("libviso_torch" + ("." + sub if sub else ""),
            RENAMED.get(symbol, symbol))


def test_surface_is_read():
    assert len(SURFACE) > 60
    assert ("libviso_tpu.utils.profiling", "time_jitted") in SURFACE
    assert all(m.startswith("libviso_tpu") for m, _ in SURFACE)


@pytest.mark.parametrize("module,symbol", SURFACE,
                         ids=[f"{m}.{s}" for m, s in SURFACE])
def test_port_has_counterpart(module, symbol):
    mod_name, name = _counterpart(module, symbol)
    mod = importlib.import_module(mod_name)
    assert hasattr(mod, name), f"{mod_name}.{name} missing (for " \
                               f"{module}.{symbol})"
