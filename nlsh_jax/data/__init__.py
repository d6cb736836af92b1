"""Datasets: ann-benchmarks hdf5 readers, big-ann binary readers,
synthetic data, GT precompute."""

from nlsh_jax.data.binformats import (  # noqa: F401
    BigBinaryDataset,
    read_bin,
    read_bin_header,
    read_gt_bin,
    write_bin,
    write_gt_bin,
)
from nlsh_jax.data.datasets import (  # noqa: F401
    Dataset,
    Glove,
    SIFT,
    SyntheticDataset,
    get_data_by_id,
)
