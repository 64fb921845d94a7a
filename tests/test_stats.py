"""Reduction-statistics ops (ops/stats.py) beyond the coverage in
test_image_ops.py."""

import numpy as np
def test_kmeans_recovers_clusters():
    """ops/stats.kmeans (jittable Lloyd; reference's cv2.kmeans analog,
    DenseOF.py:326-345) separates well-separated clusters exactly."""
    import jax
    import jax.numpy as jnp
    from hackathonopticalflow_tpu.ops.stats import kmeans

    rng = np.random.RandomState(0)
    true_centers = np.array([[0.0, 0.0], [10.0, 10.0], [20.0, -5.0]])
    pts = np.concatenate(
        [true_centers[i] + rng.normal(0, 0.3, (50, 2)) for i in range(3)]
    ).astype(np.float32)
    comp, labels, centers = jax.jit(lambda s: kmeans(s, 3, iters=20))(
        jnp.asarray(pts)
    )
    centers = np.asarray(centers)
    # each true center matched within noise
    d = np.linalg.norm(centers[:, None] - true_centers[None], axis=-1)
    assert (d.min(axis=0) < 0.2).all()
    labels = np.asarray(labels)
    for i in range(3):
        seg = labels[i * 50 : (i + 1) * 50]
        assert (seg == seg[0]).all()  # cluster membership coherent
    assert float(comp) < 150 * 2 * 0.3**2 * 3
