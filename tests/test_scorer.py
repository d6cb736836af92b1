"""The XLA block scorer of the layout engines against numpy.

``block_scores`` (one batched matrix product per group at
``Precision.HIGHEST``) plus the per-row int8 dequant and euclidean bias
must reproduce a float64 numpy rerank of the rows the layout stores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsh_jax.index.bucket_table import build_bucket_table
from nlsh_jax.index.serving import _dequant_bias
from nlsh_jax.ops.pallas.query_kernel import (
    block_scores,
    extend_queries,
    serving_layout,
)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_block_scores_match_numpy(dtype, metric):
    rng = np.random.default_rng(3)
    n, d, nb, br, g, G = 700, 20, 4, 128, 9, 5
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    table = build_bucket_table(
        jnp.asarray(rng.integers(0, nb, n).astype(np.int32)), nb)
    layout = serving_layout(table, jnp.asarray(corpus), metric=metric,
                            dtype=jnp.dtype(dtype), block_rows=br, align=br)
    queries = rng.normal(size=(g * G, d)).astype(np.float32)
    qe = extend_queries(layout, jnp.asarray(queries)).reshape(g, G, -1)
    n_blocks = layout.n_rows // br
    grp_block = jnp.asarray(rng.integers(0, n_blocks, g).astype(np.int32))

    got = _dequant_bias(layout, block_scores(layout.data, qe, grp_block,
                                             block_rows=br), grp_block)
    got = np.asarray(got)  # (g, G, br)

    # float64 reference over the stored (dequantised) rows
    data = np.asarray(layout.data)[:, :d].astype(np.float64)
    if layout.scale is not None:
        scale = np.asarray(layout.scale, np.float64)
        data = data * (scale[:, None] if scale.ndim else scale)
    rows = data.reshape(n_blocks, br, d)[np.asarray(grp_block)]
    q64 = queries.astype(np.float64).reshape(g, G, d)
    if metric == "cosine":
        q64 = q64 / np.linalg.norm(q64, axis=-1, keepdims=True)
        want = np.einsum("gqd,gbd->gqb", q64, rows)
    else:
        want = (2.0 * np.einsum("gqd,gbd->gqb", q64, rows)
                - np.einsum("gbd,gbd->gb", rows, rows)[:, None, :])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert jax.numpy.isfinite(got).all()
