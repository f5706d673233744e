"""chip_smoke.py: its phases at a tiny size on the CPU, its refusal to run
without a GPU, and (marked `gpu`) its full-size phases on the card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def small_cam():
    return cs._camera(120, 160)


def test_phase_tsdf_tiny(small_cam):
    out = cs.phase_tsdf(cam=small_cam, capacity=2048, table_size=1 << 13, kmax=1024,
                        reps=1, interpret=True)
    assert out["slots"] > 500 and out["updated_voxels"] > 100_000
    assert out["ms_per_frame"] > 0
    assert out["max_abs_sdf_err"] <= cs.VAL_TOL
    assert out["max_abs_color_err"] <= cs.VAL_TOL


def test_phase_dense_tiny(small_cam):
    out = cs.phase_dense(cam=small_cam, n_chunk=4, n_loop=8, loop_chunk=4, reps=1, ate_gate=0.05,
                         kmax=1024, interpret=True)
    assert len(out["chunk_fps"]) == 1 and out["chunk_fps"][0] > 0
    assert out["chunk_ate_m"] <= 0.05
    assert out["loop_active_blocks"] > out["active_blocks"] > 0
    assert out["mesh_triangles"] > 0


@pytest.mark.parametrize("name", ["sparse", "ba"])
def test_phase_sparse_and_ba_tiny(small_cam, name):
    phase = {"sparse": cs.phase_sparse, "ba": cs.phase_ba}[name]
    out = phase(cam=small_cam, n_chunk=4, reps=1, ate_gate=0.05)
    assert out["chunk_ate_m"] <= 0.05 and out["keyframes"] >= 1
    assert out["chunk_fps"][0] > 0


def test_phase_icp_nn_tiny():
    out = cs.phase_icp_nn(n=3000, n_check=300, reps=1)
    assert out["checked"] == 300 and out["max_abs_d2_err"] <= cs.D2_TOL
    assert out["icp_t_err_m"] < 2e-3 and out["nn_ms"] > 0


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_script_fails_without_gpu():
    proc = _run(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
    assert not _printed_result(proc.stdout)


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


@pytest.mark.gpu
def test_phase_tsdf_on_card(gpu):
    out = cs.phase_tsdf()
    assert out["max_abs_sdf_err"] <= cs.VAL_TOL


@pytest.mark.gpu
def test_phase_icp_nn_on_card(gpu):
    out = cs.phase_icp_nn()
    assert out["max_abs_d2_err"] <= cs.D2_TOL


@pytest.mark.gpu
def test_descriptor_bits_match_cpu_on_card(gpu):
    """The int8 x int8 -> int32 BRIEF matmul gives the card the same
    descriptor bits as the CPU for the same int8 patches."""
    import jax
    import numpy as np

    from onepiece_tpu.odometry import features as feat
    from onepiece_tpu.utils import synthetic

    cpu = jax.devices("cpu")[0]
    grays, _ = cs._render(cs._camera(), synthetic.orbit_trajectory(16)[:2])
    kp = feat.detect_and_describe_batch(grays)
    sx = np.asarray(kp.uv[..., 0]).astype(np.int32)
    sy = np.asarray(kp.uv[..., 1]).astype(np.int32)
    g = jax.device_put(np.asarray(grays), cpu)
    patches = feat._gather_patches_batch(
        feat._blur5_batch(g), jax.device_put(sx, cpu), jax.device_put(sy, cpu)
    )
    _, on_cpu = feat._describe_patches(patches)
    _, on_card = feat._describe_patches(jax.device_put(np.asarray(patches), gpu))
    valid = np.asarray(kp.valid).reshape(-1)
    np.testing.assert_array_equal(np.asarray(on_card)[valid], np.asarray(on_cpu)[valid])
