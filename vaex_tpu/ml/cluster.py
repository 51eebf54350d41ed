"""KMeans clustering on the device (reference: vaex-ml/vaex/ml/cluster.py,
228 LoC of numba Lloyd kernels).

Re-design as matmuls instead of a per-row numba loop: per Lloyd step the
squared distances come from ONE matmul per tile (||x||^2 - 2 x.C^T +
||C||^2), assignments are an argmin, and the centroid statistics come from
a one-hot matmul (onehot^T @ X) — the same batched-matmul shape the
aggregation kernels use.  All ``n_init`` runs are batched on a leading
axis, so one jitted step advances every run at once.  Fit streams the
frame in chunks (out-of-core, like the reference's map-reduce execute),
and the fitted transform is a virtual column backed by a registered
DataFrame function — pure DataFrame state, like every other transformer.
"""

from __future__ import annotations

import numpy as np

from .transformations import Transformer


_LLOYD_CACHE = []


def _lloyd_step_factory():
    # one jitted pair per process: rebuilding the closures would retrace
    # and recompile on every call
    if _LLOYD_CACHE:
        return _LLOYD_CACHE[0]
    import jax
    import jax.numpy as jnp

    # float32 products at HIGHEST precision: a GPU would otherwise run them
    # in TF32 (~1e-3 relative), enough to flip the nearest centroid of a
    # point near a boundary; with it, inertia matches a float32 numpy
    # Lloyd step to float32 rounding
    hi = jax.lax.Precision.HIGHEST

    @jax.jit
    def tile_stats(centroids, X):
        """centroids [R, K, D], X [T, D] ->
        (counts [R, K], sums [R, K, D], inertia [R])."""
        x2 = jnp.sum(X * X, axis=1)                         # [T]
        c2 = jnp.sum(centroids * centroids, axis=2)         # [R, K]
        # d2[r, t, k] = ||x_t - c_rk||^2, the cross term as a matmul
        cross = jnp.einsum("td,rkd->rtk", X, centroids, precision=hi)  # [R, T, K]
        d2 = x2[None, :, None] - 2.0 * cross + c2[:, None, :]
        best = jnp.argmin(d2, axis=2)                       # [R, T]
        inertia = jnp.sum(jnp.min(d2, axis=2), axis=1)      # [R]
        K = centroids.shape[1]
        onehot = (best[:, :, None] ==
                  jnp.arange(K)[None, None, :]).astype(X.dtype)  # [R, T, K]
        counts = jnp.sum(onehot, axis=1)                    # [R, K]
        sums = jnp.einsum("rtk,td->rkd", onehot, X, precision=hi)  # [R, K, D]
        return counts, sums, inertia

    @jax.jit
    def assign(centroids, X):
        c2 = jnp.sum(centroids * centroids, axis=1)
        cross = jnp.matmul(X, centroids.T, precision=hi)
        d2 = -2.0 * cross + c2[None, :]
        return jnp.argmin(d2, axis=1)

    _LLOYD_CACHE.append((tile_stats, assign))
    return tile_stats, assign


class KMeans(Transformer):
    """Lloyd's algorithm with ``n_init`` batched restarts
    (reference cluster.py:66 KMeans; same trait surface: n_clusters,
    init, max_iter, n_init, random_state, verbose)."""

    snake_name = "kmeans"

    def __init__(self, features=None, n_clusters=2, init="random", n_init=1,
                 max_iter=300, tol=1e-4, random_state=None, verbose=False,
                 prediction_label="prediction_kmeans", chunk_size=4_000_000):
        super().__init__(features, "")
        self.n_clusters = int(n_clusters)
        self.init = init
        self.n_init = int(n_init)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.random_state = random_state
        self.verbose = verbose
        self.prediction_label = prediction_label
        self.chunk_size = int(chunk_size)
        self.cluster_centers_ = None
        self.inertia_ = None
        self.inertias_ = None   # per-iteration best-run inertia trace

    # -- fit -----------------------------------------------------------------
    def _chunks(self, df):
        n = len(df)
        for i1 in range(0, n, self.chunk_size):
            i2 = min(i1 + self.chunk_size, n)
            sub = df[i1:i2] if (i1, i2) != (0, n) else df
            cols = [np.asarray(sub.evaluate(f, array_type="numpy"), dtype="f8")
                    for f in self.features]
            yield np.stack(cols, axis=1)

    def _init_centroids(self, df, rng):
        if isinstance(self.init, (list, tuple, np.ndarray)):
            c = np.asarray(self.init, dtype="f8")
            return np.broadcast_to(c, (self.n_init,) + c.shape).copy()
        # random rows (reference generate_cluster_centers_random): sample
        # K rows per run from the first chunk (or the whole frame if small)
        X0 = next(self._chunks(df))
        runs = []
        for _ in range(self.n_init):
            idx = rng.choice(X0.shape[0], size=self.n_clusters, replace=False)
            runs.append(X0[idx])
        return np.stack(runs)                                # [R, K, D]

    def fit(self, df):
        import jax.numpy as jnp
        if not self.features:
            raise ValueError("KMeans needs features")
        rng = np.random.default_rng(self.random_state)
        tile_stats, _ = _lloyd_step_factory()
        centroids = jnp.asarray(self._init_centroids(df, rng))  # [R, K, D]
        R, K, D = centroids.shape
        prev_inertia = None
        self.inertias_ = []
        for iteration in range(self.max_iter):
            counts = jnp.zeros((R, K))
            sums = jnp.zeros((R, K, D))
            inertia = jnp.zeros((R,))
            for X in self._chunks(df):
                c, s, i = tile_stats(centroids, jnp.asarray(X))
                counts, sums, inertia = counts + c, sums + s, inertia + i
            # empty clusters keep their previous centroid (no NaN poisoning)
            new = jnp.where(counts[:, :, None] > 0,
                            sums / jnp.maximum(counts[:, :, None], 1.0),
                            centroids)
            centroids = new
            inertia_np = np.asarray(inertia)
            self.inertias_.append(float(inertia_np.min()))
            if self.verbose:
                print(f"KMeans iteration {iteration}, inertia {inertia_np}")
            if prev_inertia is not None:
                rel = np.abs(prev_inertia - inertia_np) / np.maximum(prev_inertia, 1e-300)
                if np.all(rel < self.tol):
                    break
            prev_inertia = inertia_np
        # pick the restart by the FINAL iteration's inertia (selecting on the
        # previous iteration's vector could crown a run that is no longer
        # the minimum)
        best = int(np.argmin(inertia_np))
        self.cluster_centers_ = np.asarray(centroids[best]).tolist()
        self.inertia_ = float(inertia_np[best])
        return self

    # -- predict / transform --------------------------------------------------
    def predict(self, df):
        _, assign = _lloyd_step_factory()
        import jax.numpy as jnp
        centers = jnp.asarray(np.asarray(self.cluster_centers_, dtype="f8"))
        outs = []
        for X in self._chunks(df):
            outs.append(np.asarray(assign(centers, jnp.asarray(X))))
        return np.concatenate(outs) if outs else np.empty(0, np.int64)

    def transform(self, df):
        df = df.copy()
        centers = np.asarray(self.cluster_centers_, dtype="f8")

        def _predict(*cols):
            import jax.numpy as jnp
            _, assign = _lloyd_step_factory()
            X = np.stack([np.asarray(c, dtype="f8") for c in cols], axis=1)
            return np.asarray(assign(jnp.asarray(centers), jnp.asarray(X)))

        name = df.add_function("kmeans_predict", _predict, vectorize=True,
                               unique=True)
        df[self.prediction_label] = f"{name}({', '.join(map(str, self.features))})"
        return df
