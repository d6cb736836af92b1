#!/usr/bin/env python
"""Serve an index from a saved model (standalone query engine).

Example:
    python serve.py --model_path <base> --data_id synthetic \
        --index_path /tmp/idx.npz -k 10
"""
from nlsh_jax.cli.serve import main

if __name__ == "__main__":
    from nlsh_jax.utils.env import setup_compile_cache

    setup_compile_cache()
    main()
