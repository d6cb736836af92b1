"""Native C++ kernel tests: ctypes + XLA FFI paths vs the jitted ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsh_jax import native
from nlsh_jax.index.bucket_table import build_bucket_table
from nlsh_jax.ops import packing


@pytest.fixture(scope="module")
def codes():
    return np.random.default_rng(0).integers(0, 2, (32, 10, 12), dtype=np.int32)


def test_pack_codes_matches_jitted(codes):
    got = native.pack_codes(codes)
    expected = np.asarray(packing.pack_bits(jnp.asarray(codes)))
    np.testing.assert_array_equal(got, expected)


def test_hash_codes_matches_jitted(codes):
    ids, valid = native.hash_codes(codes)
    jids, jvalid = packing.hash_codes(jnp.asarray(codes))
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(valid, np.asarray(jvalid))


def test_build_csr_matches_jitted():
    b = np.random.default_rng(1).integers(0, 64, 1000).astype(np.int32)
    r, s, c = native.build_csr(b, 64)
    t = build_bucket_table(jnp.asarray(b), 64)
    np.testing.assert_array_equal(r, np.asarray(t.row_ids))
    np.testing.assert_array_equal(s, np.asarray(t.starts))
    np.testing.assert_array_equal(c, np.asarray(t.counts))


def test_build_csr_sentinel_dropped():
    """Out-of-range ids (shard-padding sentinel) drop from counts and
    sort last — same contract as the jitted build."""
    b = np.array([3, 8, 0, 8, 3], dtype=np.int32)  # n_buckets=8 -> 8 is sentinel
    r, s, c = native.build_csr(b, 8)
    assert c.sum() == 3
    assert c[3] == 2 and c[0] == 1
    assert set(r[-2:].tolist()) == {1, 3}  # sentinel rows at the end


def test_ffi_pack_dedupe_under_jit(codes):
    if native._get_lib() is None:
        pytest.skip("no native toolchain")
    ids, valid = jax.jit(native.pack_dedupe_ffi)(jnp.asarray(codes))
    nids, nvalid = native.hash_codes(codes)
    np.testing.assert_array_equal(np.asarray(ids), nids)
    np.testing.assert_array_equal(np.asarray(valid), nvalid)


def test_ffi_build_csr_under_jit():
    if native._get_lib() is None:
        pytest.skip("no native toolchain")
    b = np.random.default_rng(2).integers(0, 32, 500).astype(np.int32)
    r, s, c = jax.jit(lambda x: native.build_csr_ffi(x, 32))(jnp.asarray(b))
    nr, ns, nc = native.build_csr(b, 32)
    np.testing.assert_array_equal(np.asarray(r), nr)
    np.testing.assert_array_equal(np.asarray(s), ns)
    np.testing.assert_array_equal(np.asarray(c), nc)


def test_numpy_fallbacks_match_native(codes, monkeypatch):
    """The no-toolchain fallbacks must be value-identical."""
    ids_n, valid_n = native.hash_codes(codes)
    csr_in = np.random.default_rng(3).integers(0, 16, 300).astype(np.int32)
    r_n, s_n, c_n = native.build_csr(csr_in, 16)
    pack_n = native.pack_codes(codes)

    monkeypatch.setattr(native, "_get_lib", lambda: None)
    ids_f, valid_f = native.hash_codes(codes)
    r_f, s_f, c_f = native.build_csr(csr_in, 16)
    pack_f = native.pack_codes(codes)

    np.testing.assert_array_equal(ids_n, ids_f)
    np.testing.assert_array_equal(valid_n, valid_f)
    np.testing.assert_array_equal(r_n, r_f)
    np.testing.assert_array_equal(s_n, s_f)
    np.testing.assert_array_equal(c_n, c_f)
    np.testing.assert_array_equal(pack_n, pack_f)
