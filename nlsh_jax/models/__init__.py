"""Hashing models: encoder trunks and hashing heads (pure pytree params)."""

from nlsh_jax.models.encoders import (  # noqa: F401
    MLPEncoder,
    SirenEncoder,
    TwoLayer256Relu,
    get_encoder,
)
from nlsh_jax.models.hashings import (  # noqa: F401
    MultivariateBernoulli,
    Categorical,
    ProductQuantization,
    get_hashing,
)
