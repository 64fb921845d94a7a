"""Test harness configuration.

All tests run on CPU with 8 virtual devices (XLA host-platform device
count) so the distributed paths (shard_map tiling, halo exchange,
collective statistics) are exercised without accelerators — the strategy
from SURVEY.md §4. The platform is also forced through jax.config in case
jax was imported before this file set the environment.

Golden tests read seeded synthetic frames with known motion
(hackathonopticalflow_tpu/io/synthetic.py) and compare against the cv2
oracle where it is installed.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VIDEO_DIR = "/root/reference/videos"
CLIP_CORRIDOR = os.path.join(VIDEO_DIR, "Тёмный_коридор_колонны .mp4")
CLIP_BUILDINGS = os.path.join(VIDEO_DIR, "здания_дверь_колонны_перекрытия.mp4")

try:
    import cv2

    HAVE_CV2 = True
except ImportError:
    cv2 = None
    HAVE_CV2 = False

requires_cv2 = pytest.mark.skipif(not HAVE_CV2, reason="cv2 oracle unavailable")


@pytest.fixture(scope="session")
def frame_pair():
    """Consecutive 1080p gray frames of the seeded clip (expansion about
    an off-centre FOE, drift, two discs moving > 40 px per frame)."""
    from hackathonopticalflow_tpu.io.synthetic import seeded_pair

    return seeded_pair(1080, 1920, seed=0)


@pytest.fixture(scope="session")
def frame_pair_small():
    """The same scene at 480x270 — keeps CPU golden tests fast."""
    from hackathonopticalflow_tpu.io.synthetic import seeded_pair

    return seeded_pair(270, 480, seed=0)


@pytest.fixture(scope="session")
def bgr_frame():
    from hackathonopticalflow_tpu.io.synthetic import seeded_bgr_frame

    return seeded_bgr_frame(270, 480, seed=0)
