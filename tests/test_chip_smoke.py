"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
checks and its four-card phase work at small sizes (on virtual CPU
devices)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_refuses_without_gpu(args):
    res = _run(ROOT, *args)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_four_selects_only_its_phase():
    assert chip_smoke.phases(four=True) == ["device", "four"]
    one = chip_smoke.phases(four=False)
    assert "four" not in one and one[0] == "device"
    assert set(one) | {"four"} == set(chip_smoke.PHASES)


def test_phase_four_on_virtual_devices():
    """The sharded paths against one device, on 4 of the suite's 8
    virtual CPU devices, at a small frame size."""
    chip_smoke.phase_four({}, n_frames=4, h=64, w=64)


@pytest.mark.parametrize("shape", [(2, 64, 80, 3), (1, 128, 128, 3)])
def test_entropy_exact_and_numpy_reference(shape):
    """One-table (v0) and per-subband (v2) grans streams both decode
    with the smoke's NumPy reference decoder."""
    from vcf_tpu.entropy import get

    rng = np.random.default_rng(0)
    planes = np.clip(128 + rng.geometric(0.4, shape) - 1, 0, 255).astype(
        np.uint8)
    codec = get("grans")
    _, side = codec.encode(planes)
    assert side["grans_model"][0] == (0 if shape[0] == 2 else 2)
    chip_smoke.check_entropy_exact(planes, codec)


def test_dwt_lanes_exact():
    from vcf_tpu.io import test_image

    chip_smoke.check_dwt_lanes_exact(test_image(64, 96, seed=1))


def test_report_holds_rmse_and_rate():
    res = {"rmse": [10.0], "bytes": [1000], "enc_s": [0.1, 0.2],
           "dec_s": [0.1, 0.2]}
    chip_smoke.report("x", res, {"rmse": [10.1], "bytes": [1005]}, "card")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.report("x", res, {"rmse": [10.2], "bytes": [1000]}, "c")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.report("x", res, {"rmse": [10.0], "bytes": [1020]}, "c")
