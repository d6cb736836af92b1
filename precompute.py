#!/usr/bin/env python
"""Precompute training-set self-kNN ground truth (reference precompute.py analogue).

Example:
    python precompute.py glove_100
"""
from nlsh_jax.cli.precompute import main

if __name__ == "__main__":
    from nlsh_jax.utils.env import setup_compile_cache

    setup_compile_cache()
    main()
