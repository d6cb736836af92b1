"""Tests: CSR bucket table == reference dict-of-lists semantics.

Property mirrored from the reference ``test_build_index``
(``nlsh/tests/test_indexer.py:6-26``): for every bucket id, the table's
slice must equal the dict's insertion-ordered row list.
"""

import jax.numpy as jnp
import numpy as np

from nlsh_jax.index.bucket_table import build_bucket_table


def _ref_build_index(bucket_ids):
    """Reference ``build_index`` dict semantics for hard (single-probe)
    hashing (``nlsh/indexer.py:6-24`` with one id per row)."""
    index2row = {}
    for row, b in enumerate(bucket_ids):
        index2row.setdefault(int(b), []).append(row)
    return index2row


def test_matches_reference_dict_fixture():
    # Reference fixture adapted to hard hashing: row -> single bucket.
    bucket_ids = jnp.array([1, 2, 1, 5, 2, 2], dtype=jnp.int32)
    table = build_bucket_table(bucket_ids, n_buckets=8)
    expected = {1: [0, 2], 2: [1, 4, 5], 5: [3]}
    for b in range(8):
        s = int(table.starts[b])
        c = int(table.counts[b])
        got = np.asarray(table.row_ids[s : s + c]).tolist()
        assert got == expected.get(b, [])


def test_random_table_matches_dict():
    rng = np.random.default_rng(0)
    n, n_buckets = 500, 32
    bucket_ids = rng.integers(0, n_buckets, size=n).astype(np.int32)
    table = build_bucket_table(jnp.asarray(bucket_ids), n_buckets=n_buckets)
    expected = _ref_build_index(bucket_ids)

    starts = np.asarray(table.starts)
    counts = np.asarray(table.counts)
    rows = np.asarray(table.row_ids)
    assert counts.sum() == n
    for b in range(n_buckets):
        got = rows[starts[b] : starts[b] + counts[b]].tolist()
        assert got == expected.get(b, [])


def test_stats():
    bucket_ids = jnp.array([0, 0, 0, 3, 3, 7], dtype=jnp.int32)
    table = build_bucket_table(bucket_ids, n_buckets=8)
    assert int(table.n_nonempty()) == 3
    assert int(table.max_count()) == 3
    # occupied sizes: [3, 2, 1] -> std = sqrt(2/3)
    np.testing.assert_allclose(
        float(table.occupancy_std()), np.std([3, 2, 1]), rtol=1e-6
    )
