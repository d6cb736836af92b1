"""Inverted-list index: CSR bucket table build + batched query."""

from nlsh_jax.index.bucket_table import BucketTable, build_bucket_table  # noqa: F401
from nlsh_jax.index.query import query_bucket_table  # noqa: F401
from nlsh_jax.index.indexer import Indexer  # noqa: F401
