"""hackathonopticalflow_tpu — an optical-flow / visual-navigation engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
FPV-drone pathfinder (spirinis/HackathonOpticalFlow): pyramidal Lucas-Kanade
sparse flow on measurement grids, Farneback-style dense flow, Shi-Tomasi
feature tracking with forward-backward gating, radial (focus-of-expansion)
flow normalization with robust statistical filtering and danger-point
detection — extended with ego-motion / windowed bundle adjustment and
multi-device execution (stream batching, spatial tiling with halo exchange,
distributed robust statistics) over `jax.sharding` meshes.

Subpackages
-----------
core      pytree configs, measurement grids, image conventions
ops       device ops (pyramids, derivatives, LK, Farneback, features, stats)
flow      user-facing flow ops (lk_grid_flow, farneback_flow, track_features)
nav       navigation layer (radial normalize, robust filter, danger, FOE, pose, BA)
parallel  device meshes, stream DP, spatial tiling + halo exchange, dist. stats
io        host-side video decode and device prefetch
viz       host-side layer rendering (flow glyphs, grids, HSV, lamps)
apps      runnable pipelines reproducing the reference viewers (headless-capable)
utils     logging / profiling / checkpoint helpers
"""

__version__ = "0.1.0"
