"""chip_smoke.py on the CPU: it must refuse to report a result without a
GPU, and its phases must run end to end at tiny sizes."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from ddo_tpu.models.knapsack import dp_optimum
from ddo_tpu.utils import jax_setup

SCRIPT = Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small(cs):
    pb, bundle = cs.knapsack_bundle(n=30, R=100, cls=1, h=20, seed=4)
    return pb, bundle, dp_optimum(pb)


def test_require_gpu_refuses_the_cpu(cs):
    with pytest.raises(SystemExit) as exc:
        cs.require_gpu(jax)
    assert "needs a GPU" in str(exc.value)


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(SCRIPT)], capture_output=True, text=True,
        env=env, timeout=300, cwd=SCRIPT.parent,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_phase_parity_small(cs, small, capsys):
    pb, bundle, opt = small
    cs.phase_parity(jax, bundle, opt, K=4, W=16)
    assert "bit-equal" in capsys.readouterr().out


def test_phase_kernel_small(cs, small, capsys):
    pb, bundle, opt = small
    cs.phase_kernel(jax, bundle, opt, K=4, W=16, reps=1)
    assert "exp/s" in capsys.readouterr().out


def test_phase_proof_small(cs, small, capsys):
    pb, bundle, opt = small
    cs.phase_proof(pb, bundle, opt)
    assert f"proved {opt}" in capsys.readouterr().out


def test_phase_devloop_small(cs, capsys):
    cs.phase_devloop(5, 11)
    assert "proved -11" in capsys.readouterr().out


def test_phase_multi_small(cs, small, capsys):
    pb, bundle, opt = small
    cs.phase_multi(jax, jax.devices(), pb, bundle, opt)
    out = capsys.readouterr().out
    assert "devices [0, 1, 2, 3]" in out and "MeshSolver 4" in out


def test_result_line_shape(cs, small, monkeypatch, capsys):
    """The last line is the driver's JSON object, with the device as JAX
    reports it (phases stubbed: this checks the reporting only)."""
    for name in ("phase_parity", "phase_kernel", "phase_proof", "phase_devloop"):
        monkeypatch.setattr(cs, name, lambda *a, **k: None)
    monkeypatch.setattr(cs, "card_line", lambda: "card, 700.00 W")
    monkeypatch.setattr(cs, "require_gpu", lambda jax: jax.devices())
    monkeypatch.setattr(cs, "KP", dict(n=10, R=100, cls=1, h=50, seed=0))
    # XLA:CPU executables must not enter the persistent cache (conftest)
    monkeypatch.setattr(jax_setup, "enable_compile_cache", lambda: None)
    cs.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "card, 700.00 W"
    dev = jax.devices()[0]
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}
