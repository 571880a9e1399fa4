"""The port's `entry` forward against `__graft_entry__`, and the port's
device and import rules: the card by default with no silent fall back to
the CPU, and no import of `jax`, `dsr_tpu`, `golden`, `flax` or `scipy`.

Tolerance: 1e-4 of the largest magnitude of the reference for the GMM
scores (the MVDR solve is ill-conditioned at the low bins, see
tests/test_torch_beamforming.py, and the GMM squares the features).
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from _torch_parity import rel
from dsr_tpu_torch.entry import entry
from dsr_tpu_torch.pipeline import DsrPipeline

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_entry_forward_matches_graft_entry():
    jfwd, (jx,) = __graft_entry__.entry()
    fwd, (x,) = entry("cpu")
    assert np.array_equal(x.numpy(), jx)
    ll_ref = np.asarray(jfwd(jx))
    ll = fwd(x)
    assert ll.shape == ll_ref.shape == (140, 16)
    assert rel(ll.numpy(), ll_ref) < 1e-4


def test_default_device_is_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DsrPipeline()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    assert DsrPipeline(device="cpu").device == torch.device("cpu")


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _foreign(name: str) -> bool:
    return name.startswith("jax") or name.split(".")[0] in ("dsr_tpu", "golden", "flax", "scipy")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, loaded in a fresh interpreter, pulls in no
    jax*, dsr_tpu*, golden*, flax* or scipy* module (scipy is a test-only
    dependency); and no import statement anywhere in
    the port or chip_smoke.py (function bodies included) names one."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dsr_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(dsr_tpu_torch.__path__, 'dsr_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.startswith('jax')"
        " or m.split('.')[0] in ('dsr_tpu', 'golden', 'flax', 'scipy')]\n"
        "new = {'dsr_tpu_torch.asr.' + m for m in ('tree', 'triphone', 'tritrain', 'adapt.mllr',"
        " 'adapt.fmllr', 'adapt.sat', 'adapt.vtln')} | {'dsr_tpu_torch.utils.room',"
        " 'dsr_tpu_torch.utils.objective'} | {'dsr_tpu_torch.ops.' + m for m in ('lpc', 'aec',"
        " 'sad', 'convolution', 'cmfb', 'prfft', 'modal')}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "print(len(mods), sorted(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 12 and bad.strip() == "[]", out.stdout
    files = [*sorted((REPO / "dsr_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]
    for path in files:
        foreign = sorted(n for n in _imports(path) if _foreign(n))
        assert not foreign, f"{path.relative_to(REPO)} imports {foreign}"
