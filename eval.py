#!/usr/bin/env python
"""Multi-probe sweep evaluation of a saved model (reference eval.py analogue).

Example:
    python eval.py --model_path /tmp/nlsh_models/run_300_0.8123 --data_id glove_100
"""
from nlsh_jax.cli.evaluate import main

if __name__ == "__main__":
    from nlsh_jax.utils.env import setup_compile_cache

    setup_compile_cache()
    main()
