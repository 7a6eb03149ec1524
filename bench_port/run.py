"""The port's benchmark: run one cell of BENCHMARK.json on the card.

    python3 bench_port/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  Prints the run's result as one JSON object,
the last line of standard output; the numbers the output check compared,
each beside its limit, are the last lines of standard error.  Exits 2
without a result where CUDA is missing or the card count is short of the
cell's, and 1 where the run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    # transformers-style JAX back ends stay off; the port needs none
    os.environ.setdefault("USE_FLAX", "0")
    from bench_port import harness
    cell = harness.load_cell(a.workload, root)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"{a.workload} needs {cell.chips} CUDA device(s); "
                    f"PyTorch sees {n}")
        return 2
    res = harness.run(cell, a.seed, a.seconds, bool(a.trace))
    bad = harness.forbidden_modules()
    if bad:
        harness.log("modules of JAX or the JAX package are loaded: "
                    + ", ".join(bad))
        return 1
    sys.stdout.write(json.dumps(res) + "\n")
    sys.stdout.flush()
    for k, v in res["check"].items():
        harness.log(f"check {k}: {v['value']} (limit {v['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
