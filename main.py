#!/usr/bin/env python
"""Train a neural-LSH hashing (reference main.py analogue).

Example:
    python main.py --data_id synthetic --learner_type triplet --debug \
        -hs 8 -es 64,64 --epochs 2
"""
from nlsh_jax.cli.train import main

if __name__ == "__main__":
    from nlsh_jax.utils.env import setup_compile_cache

    setup_compile_cache()
    main()
