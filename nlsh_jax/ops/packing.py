"""Binary-code bit packing and multi-probe dedupe.

Device-side replacement for the reference's only native kernel, the
Cython ``binarr_to_int`` / ``hash_codes`` pair (``nlsh/utils.pyx:7-32``,
compiled to a 24k-line C extension).  The reference packs an
``(n, n_probes, bits)`` int array into ``List[Set[int]]`` on the host;
here packing is a single jitted matmul against a power-of-two weight
vector (MSB-first, matching ``out = (out << 1) | bit``), and the
"set" dedupe becomes a sort + neighbour-equality mask so everything
stays fixed-shape on device.

A bit-exact C++ host kernel for host-side paths lives in
:mod:`nlsh_jax.native`.
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray

MAX_BITS = 30  # packed codes live in int32


def bit_weights(bits: int) -> Array:
    """MSB-first powers of two: ``bit_weights(3) = [4, 2, 1]``."""
    if bits > MAX_BITS:
        raise ValueError(f"bits={bits} exceeds int32 packing limit {MAX_BITS}")
    return (2 ** jnp.arange(bits - 1, -1, -1, dtype=jnp.int32)).astype(jnp.int32)


def pack_bits(codes: Array) -> Array:
    """Pack ``(..., bits)`` {0,1} codes into ``(...,)`` int32 bucket ids.

    MSB-first to match the reference ``binarr_to_int``
    (``nlsh/utils.pyx:7-15``): the first bit is the highest bit.
    """
    bits = codes.shape[-1]
    w = bit_weights(bits)
    return jnp.sum(codes.astype(jnp.int32) * w, axis=-1, dtype=jnp.int32)


def unpack_bits(ids: Array, bits: int) -> Array:
    """Inverse of :func:`pack_bits`: ``(...,) int32 -> (..., bits)`` {0,1}."""
    shifts = jnp.arange(bits - 1, -1, -1, dtype=jnp.int32)
    return (ids[..., None] >> shifts) & 1


def dedupe_codes(bucket_ids: Array) -> tuple[Array, Array]:
    """Per-row dedupe of probed bucket ids without Python sets.

    The reference's ``hash_codes`` collects multi-probe codes into a
    ``set`` per query (``nlsh/utils.pyx:19-32``); here we sort each row
    and mask repeats, keeping static shapes.

    Args:
      bucket_ids: ``(n, n_probes)`` int32.

    Returns:
      ``(sorted_ids, valid)`` both ``(n, n_probes)``; ``valid[i, j]`` is
      True for the first occurrence of each distinct id in row ``i``.
    """
    s = jnp.sort(bucket_ids, axis=-1)
    first = jnp.ones_like(s[..., :1], dtype=bool)
    rest = s[..., 1:] != s[..., :-1]
    valid = jnp.concatenate([first, rest], axis=-1)
    return s, valid


def hash_codes(codes: Array) -> tuple[Array, Array]:
    """Pack + dedupe, the full jitted equivalent of the Cython
    ``hash_codes`` (``nlsh/utils.pyx:19-32``).

    Args:
      codes: ``(n, n_probes, bits)`` {0,1}.

    Returns:
      ``(bucket_ids, valid)``: ``(n, n_probes)`` int32 sorted per row,
      with ``valid`` masking duplicate probes.
    """
    return dedupe_codes(pack_bits(codes))
