"""The benchmark's command: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up is timed from the start of this module, before torch is
imported."""

import time

T0 = time.perf_counter()

if __name__ == "__main__":
    import os
    import sys

    # a library that would load JAX by itself must not
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from portbench.harness import main

    sys.exit(main(t0=T0))
