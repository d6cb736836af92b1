"""Data-parallel training: the JAX equivalent of what DDP would be.

Every global batch is the single-device batch of the same step: device
``d`` takes the ``d``-th ``batch_size / D`` slice of it, computes the
gradient of its slice, and gradients are averaged with ``lax.pmean``
over the ``data`` mesh axis — an XLA collective (NCCL all-reduce on
GPUs).  A loss that is a mean over rows therefore gets the single-device
gradient up to summation order (a batch statistic such as the
bucket-balance term is computed per slice).  Parameters and optimizer
state stay replicated: every device applies the same averaged update.

The reference is single-GPU (survey §2: no ``torch.distributed``
anywhere); this module is the idiomatic multi-chip extension of its
training loop, not a port.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

from nlsh_jax.train.base import TrainState


def build_dp_segment_runner(loss_fn, tx, batch_size: int, mesh: Mesh):
    """Data-parallel drop-in for ``Trainer._build_segment_runner``.

    Same call signature as the single-chip runner:
    ``run(state, corpus, knn, arrays, seg_start, key, n_steps)`` — but
    each step's global batch of ``batch_size`` rows is split
    ``batch_size / D`` per device and gradients are ``pmean``-ed before
    the (replicated) optimizer update.  Corpus/knn and the epoch's
    batch-composition arrays (a few int32 per row) stay replicated, so
    each device slices its part of the same global batch as the
    single-device runner.

    Requirements: ``batch_size`` divisible by the mesh size, and every
    array in ``arrays`` trimmed to a multiple of ``n_batches *
    batch_size`` (the trainer does this).
    """
    (axis,) = mesh.axis_names
    n_dev = mesh.devices.size
    if batch_size % n_dev != 0:
        raise ValueError(
            f"batch_size {batch_size} not divisible by mesh size {n_dev}"
        )
    local_bs = batch_size // n_dev

    def run_segment(state: TrainState, corpus, knn, arrays, seg_start, key,
                    n_steps: int):
        def sharded_body(state, corpus, knn, epoch_arrays, seg_start, key):
            def body(carry: TrainState, i):
                step_in_epoch = seg_start + i
                start = (step_in_epoch * batch_size
                         + jax.lax.axis_index(axis) * local_bs)
                batch = {
                    name: jax.lax.dynamic_slice_in_dim(arr, start, local_bs)
                    for name, arr in epoch_arrays.items()
                }
                # distinct randomness per device (e.g. the proposed
                # trainer's regulariser sampling); fold the epoch-step
                # index, not the segment-local i, so segments sharing an
                # epoch key never replay per-step keys
                step_key = jax.random.fold_in(
                    jax.random.fold_in(key, step_in_epoch),
                    jax.lax.axis_index(axis),
                )

                def scalar_loss(params):
                    return loss_fn(
                        params["hashing"], params["extra"], corpus, knn,
                        batch, step_key,
                    )

                loss, grads = jax.value_and_grad(scalar_loss)(carry.params)
                grads = jax.lax.pmean(grads, axis)  # all-reduce across the data axis
                loss = jax.lax.pmean(loss, axis)
                updates, opt_state = tx.update(grads, carry.opt_state, carry.params)
                params = optax.apply_updates(carry.params, updates)
                return TrainState(params, opt_state, carry.step + 1), loss

            return jax.lax.scan(body, state, jnp.arange(n_steps))

        sharded = shard_map(
            sharded_body,
            mesh=mesh,
            in_specs=(
                P(),                                   # state: replicated
                P(),                                   # corpus: replicated
                P(),                                   # knn: replicated
                jax.tree.map(lambda _: P(), arrays),  # epoch arrays: replicated
                P(),                                   # seg_start
                P(),                                   # key
            ),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return sharded(state, corpus, knn, arrays, seg_start, key)

    return jax.jit(run_segment, static_argnames=("n_steps",))
