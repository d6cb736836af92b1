"""Pure-functional numeric kernels (jnp/lax only, all jittable)."""

from nlsh_jax.ops import distances, code_distances, packing, knn  # noqa: F401
