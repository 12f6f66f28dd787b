"""Driver entry point: delegates to the packaged benchmark
(defl_jax/bench.py; `defl-jax-bench` / `python -m defl_jax.bench` after
pip install).  Prints ONE JSON line with the headline inflate GB/s."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from defl_jax.bench import main

if __name__ == "__main__":
    main()
