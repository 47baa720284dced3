"""chip_smoke.py on the CPU: its phase functions at tiny sizes (the CPU
device standing in for the card, kernels in interpret mode), its helpers,
and its refusal to run without a GPU or outside a checkout."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.heavy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def _ok_lines(stdout: str):
    return [ln for ln in stdout.splitlines() if '"ok"' in ln]


def test_refuses_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert not _ok_lines(out.stdout)


def test_refuses_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(lone)], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not _ok_lines(out.stdout)


def test_read_png_roundtrip(smoke, tmp_path):
    from pathtracerpython_tpu.render.image import save_png

    img = (np.random.default_rng(0).random((5, 7, 3)) * 255).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    save_png(img, path)
    np.testing.assert_array_equal(smoke.read_png(path), img)


def test_compare_sweeps_tie_rules(smoke):
    t = np.array([1.0, 2.0, 3.0, 4.0])
    i = np.array([0, 1, 2, 3])
    assert smoke.compare_sweeps(t, i, t, i) == (0.0, 0.0)
    # a tie (same t, other winner) and a grazing miss are allowed
    share, _ = smoke.compare_sweeps(
        t, np.array([0, 5, 2, -1]), t, i)
    assert share == 0.5
    # a different winner at a clearly different distance is not
    with pytest.raises(smoke.SmokeFailure):
        smoke.compare_sweeps(np.array([1.0, 2.5]), np.array([0, 4]),
                             np.array([1.0, 2.0]), np.array([0, 1]))
    # nor is a t gap on the same winner
    with pytest.raises(smoke.SmokeFailure):
        smoke.compare_sweeps(np.array([1.1]), np.array([0]),
                             np.array([1.0]), np.array([0]))


def test_phase_cornell_tiny(smoke, cpu, tmp_path, capsys):
    rad = smoke.phase_cornell(cpu, str(tmp_path), size=16, spp=1,
                              bounces=2, cmp_size=8, cmp_spp=1)
    assert rad.shape == (256, 3)
    assert os.path.exists(tmp_path / "cornell_16.png")
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("[cornell] compile_s=") for ln in lines) == 3


def test_phase_boxfield_tiny(smoke, cpu, capsys):
    t_kernel, t_xla = smoke.phase_boxfield(
        cpu, size=16, spp=1, bounces=2, n_boxes=40, reps=1, interpret=True)
    assert t_kernel > 0 and t_xla > 0
    out = capsys.readouterr().out
    assert "primary wavefront" in out and "NEE wavefront" in out
    assert "memory_analysis" in out


def test_phase_inverse_tiny(smoke, cpu, capsys):
    smoke.phase_inverse(cpu, size=16, steps=2, cmp_size=8)
    out = capsys.readouterr().out
    assert "albedo steps" in out and "soft render" in out


def test_phase_four_tiny(smoke, capsys):
    results = smoke.phase_four(size=16)
    assert set(results) == {"dp4", "dp2_geom2"}
    assert "dp=4 grads vs one card" in capsys.readouterr().out
