"""Cross-cutting utilities: metrics, loggers, checkpointing, env config."""

from nlsh_jax.utils import metrics  # noqa: F401
