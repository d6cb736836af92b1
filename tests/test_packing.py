"""Tests for bit packing + multi-probe dedupe — the jitted replacement
of the reference Cython kernel (``nlsh/utils.pyx:7-32``)."""

import jax.numpy as jnp
import numpy as np

from nlsh_jax.ops import packing


def _ref_binarr_to_int(binarr):
    """Host reimplementation of the reference semantics
    (``utils.pyx:7-15``, also ``eval.py:49-53``)."""
    out = 0
    for bit in binarr:
        out = (out << 1) | int(bit)
    return out


def test_pack_bits_msb_first():
    codes = jnp.array([[1, 0, 1], [0, 1, 1], [0, 0, 0], [1, 1, 1]], dtype=jnp.int32)
    got = np.asarray(packing.pack_bits(codes))
    expected = [_ref_binarr_to_int(row) for row in np.asarray(codes)]
    np.testing.assert_array_equal(got, expected)  # [5, 3, 0, 7]


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 2, (17, 12), dtype=np.int32))
    ids = packing.pack_bits(codes)
    back = packing.unpack_bits(ids, 12)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(codes))


def test_pack_bits_batched_shapes():
    rng = np.random.default_rng(1)
    codes = jnp.asarray(rng.integers(0, 2, (4, 7, 9), dtype=np.int32))
    ids = packing.pack_bits(codes)
    assert ids.shape == (4, 7)
    flat = np.asarray(codes).reshape(-1, 9)
    expected = np.array([_ref_binarr_to_int(r) for r in flat]).reshape(4, 7)
    np.testing.assert_array_equal(np.asarray(ids), expected)


def test_hash_codes_matches_reference_sets():
    """The (sorted ids, valid mask) pair must encode exactly the
    per-query sets the Cython ``hash_codes`` builds."""
    rng = np.random.default_rng(2)
    codes_np = rng.integers(0, 2, (32, 10, 6), dtype=np.int32)
    ids, valid = packing.hash_codes(jnp.asarray(codes_np))
    ids, valid = np.asarray(ids), np.asarray(valid)
    for i in range(codes_np.shape[0]):
        expected_set = {_ref_binarr_to_int(c) for c in codes_np[i]}
        got_set = set(ids[i][valid[i]].tolist())
        assert got_set == expected_set
        # every invalid slot duplicates a valid one
        assert set(ids[i].tolist()) == got_set


def test_dedupe_all_identical():
    ids = jnp.array([[3, 3, 3, 3]], dtype=jnp.int32)
    s, valid = packing.dedupe_codes(ids)
    assert np.asarray(valid).sum() == 1


def test_bit_weights_limit():
    try:
        packing.bit_weights(31)
    except ValueError:
        pass
    else:
        raise AssertionError("expected ValueError for > 30 bits")
