"""Build-time gather canary for the serving path.

An earlier accelerator backend this system ran on silently MISCOMPILED
2-D row gathers ``table[idx2d]`` from big lane-padded tables (observed
at a ``(917k, 10)`` f32/int32 table with ``(10k, 96)`` indices: wrong
rows, varying per compilation, invisible at atol 1e-3 on clustered
data).  The serving engines regroup through full-width (128-column)
tables (``serving._pack_panels``) and flattened 1-D gathers — but the
failure mode is silent and per-compilation, so a compiler update could
reintroduce it and nothing in the serve path would notice.

This module runs the exact gather pattern the engines rely on — a 2-D
row gather of sampled rows from a large 128-column int32 table whose
every element encodes its own (row, column) — on the current backend
and compares the result BITWISE against the host-computed expectation.
Float tolerances cannot catch rank-scrambling reads; encoding indices
in int32 makes any wrong-row read an exact, loud mismatch.

Wired into :class:`nlsh_jax.index.Indexer` (and the multi-table
stacked layout) at serving-layout construction: the first layout built
on an accelerator backend (anything but the CPU) in each process pays
one canary compile; mismatch raises :class:`GatherMiscompileError`
instead of serving wrong neighbours.  ``NLSH_GATHER_CANARY=0``
disables (e.g. for timing runs); ``NLSH_GATHER_CANARY_ROWS`` overrides
the table height.

Reference counterpart: none — the reference's torch gathers
(``nlsh/indexer.py:74-83``) never faced an XLA compiler between them
and device memory.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# past ~800k rows the observed miscompile class kicked in; the canary
# table sits above it.  128 columns = the width of the serving panel
# tables (serving._pack_panels).
_CANARY_ROWS = 1_048_576
_CANARY_WIDTH = 128
_CANARY_IDX = (128, 32)  # 2-D index shape, like (nq, events) regroups

#: backends (by ``jax.default_backend()``) already verified this process
_verified: set[str] = set()


class GatherMiscompileError(RuntimeError):
    """The backend returned wrong rows for the serving gather pattern."""


@partial(jax.jit, static_argnames=("n_rows", "width"))
def _device_gather(idx2d, n_rows: int, width: int):
    """Materialise ``table[r, c] = r * width + c`` (int32, exact) and
    row-gather ``idx2d`` through it — the engines' regroup pattern.
    The barrier stops XLA folding the gather into the iota (which would
    test nothing)."""
    table = (
        jnp.arange(n_rows, dtype=jnp.int32)[:, None] * width
        + jnp.arange(width, dtype=jnp.int32)[None, :]
    )
    table = jax.lax.optimization_barrier(table)
    return table[idx2d]


def check_gather_integrity(n_rows: int | None = None,
                           width: int = _CANARY_WIDTH,
                           force: bool = False) -> bool:
    """Run the canary once per process per backend.  Returns True when
    verified (or skipped: CPU backend / env kill-switch), raises
    :class:`GatherMiscompileError` on a bitwise mismatch.  ``force``
    runs it on the CPU too, and again even if already verified."""
    if os.environ.get("NLSH_GATHER_CANARY", "1") == "0":
        return True
    backend = jax.default_backend()
    if backend == "cpu" and not force:
        # CPU row gathers are not the hazard class; CI covers the code
        # path via ``force=True`` tests
        return True
    if backend in _verified and not force:
        return True
    if n_rows is None:
        n_rows = int(os.environ.get("NLSH_GATHER_CANARY_ROWS",
                                    _CANARY_ROWS))
    rng = np.random.default_rng(0)
    idx = rng.integers(0, n_rows, size=_CANARY_IDX).astype(np.int32)
    # always include the edges the miscompile favoured (high rows)
    idx[0, :4] = [0, 1, n_rows - 2, n_rows - 1]
    got = np.asarray(_device_gather(jnp.asarray(idx), n_rows, width))
    want = (idx.astype(np.int64)[:, :, None] * width
            + np.arange(width, dtype=np.int64)[None, None, :]
            ).astype(np.int32)
    if not np.array_equal(got, want):
        bad = np.nonzero(~np.all(got == want, axis=2))
        n_bad = bad[0].size
        r0 = int(idx[bad[0][0], bad[1][0]]) if n_bad else -1
        raise GatherMiscompileError(
            f"backend {backend!r} miscompiled the serving row-gather "
            f"pattern: {n_bad}/{idx.size} gathered rows are wrong "
            f"(first bad source row {r0}, table ({n_rows}, {width}) "
            "int32).  Row-gather results on this backend are untrusted "
            "— serving would silently return wrong neighbours.  "
            "Set NLSH_GATHER_CANARY=0 only to debug."
        )
    _verified.add(backend)
    return True
