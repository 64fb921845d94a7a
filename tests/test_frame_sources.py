"""Frame stacks as a video source (no cv2 needed), the seeded synthetic
clip, and the compile-cache helper the entry points call."""

import os
import sys

import numpy as np
import pytest

import jax

from hackathonopticalflow_tpu.io.prefetch import FramePrefetcher
from hackathonopticalflow_tpu.io.synthetic import seeded_clip
from hackathonopticalflow_tpu.io.video import DEFAULT_FPS, VideoReader, to_gray
from hackathonopticalflow_tpu.utils import compile_cache


def test_video_reader_npy_gray(tmp_path):
    frames = np.random.RandomState(0).randint(0, 256, (5, 24, 32), dtype=np.uint8)
    path = str(tmp_path / "clip.npy")
    np.save(path, frames)
    with VideoReader(path) as vr:
        assert (vr.length, vr.height, vr.width, vr.fps) == (5, 24, 32, DEFAULT_FPS)
        np.testing.assert_array_equal(vr.read(), frames[0])
        vr.seek(3)
        np.testing.assert_array_equal(vr.read_gray(), frames[3])
        assert [f.shape for f in vr.frames(start=1, count=2)] == [(24, 32)] * 2
        vr.seek(5)
        assert vr.read() is None


def test_video_reader_npz_bgr_with_fps(tmp_path):
    frames = np.random.RandomState(1).randint(0, 256, (3, 16, 20, 3), dtype=np.uint8)
    path = str(tmp_path / "clip.npz")
    np.savez(path, frames=frames, fps=30.0)
    with VideoReader(path) as vr:
        assert vr.fps == 30.0 and vr.length == 3
        np.testing.assert_array_equal(vr.read_gray(), to_gray(frames[0]))


@pytest.mark.parametrize(
    "bad", [np.zeros((4, 8, 8), np.float32), np.zeros((8, 8), np.uint8)]
)
def test_video_reader_rejects_non_frame_stacks(tmp_path, bad):
    path = str(tmp_path / "bad.npy")
    np.save(path, bad)
    with pytest.raises(ValueError):
        VideoReader(path)


def test_video_reader_missing_stack(tmp_path):
    with pytest.raises(FileNotFoundError):
        VideoReader(str(tmp_path / "absent.npy"))


def test_prefetcher_passes_gray_frames_through(tmp_path):
    frames = np.random.RandomState(2).randint(0, 256, (4, 12, 16), dtype=np.uint8)
    path = str(tmp_path / "clip.npy")
    np.save(path, frames)
    got = list(FramePrefetcher(path, start_frame=1, to_device=False))
    np.testing.assert_array_equal(np.stack(got), frames[1:])


def test_pathfinder_runs_frame_stack_without_cv2(tmp_path, monkeypatch):
    """The chunked pipeline on a frame stack imports no cv2."""
    from hackathonopticalflow_tpu.apps.pathfinder import parse_cli, run_cli

    path = str(tmp_path / "clip.npy")
    np.save(path, seeded_clip(5, 90, 120, seed=3))
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    cfg, args = parse_cli([path, "--chunk", "2", "--no-render", "--step", "30"])
    stats = run_cli(cfg, args)
    assert stats["frames"] == 4
    assert len(stats["danger_counts"]) == 4


def test_seeded_clip_is_deterministic_and_moves():
    a = seeded_clip(3, 60, 80, seed=7)
    b = seeded_clip(3, 60, 80, seed=7)
    assert a.dtype == np.uint8 and a.shape == (3, 60, 80)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a[1].astype(int) - a[0]).mean() > 1.0  # frames differ
    assert not np.array_equal(a, seeded_clip(3, 60, 80, seed=8))


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu(tmp_path):
    """Without a GPU the smoke script exits non-zero and prints no result."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "chip_smoke.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no GPU" in out.stderr
