#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card.

    python3 aptbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with the reference beside its limit,
which also close standard error.  Without a card, or with fewer cards than
the cell asks for, it prints no result and exits with 2; a failure
anywhere else exits with 1, also without a result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))
# Python's bytecode, torch's included, is compiled on a checkout's first run
# and kept inside the checkout at a fixed path: where the environment writes
# none (PYTHONDONTWRITEBYTECODE), every run would compile torch's sources
# anew, seconds of set-up that swing with the host's load.
sys.pycache_prefix = str(ROOT / ".aptbench_cache" / "pycache")
sys.dont_write_bytecode = False

from aptbench import harness  # noqa: E402


def main(argv=None) -> int:
    age0 = max(0.0, harness.process_age_s() - (time.perf_counter() - T0))
    p = argparse.ArgumentParser(description="Run one benchmark cell once on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                                  device="cuda", age0=age0, t0=T0)
    except harness.Refused as e:
        print(f"aptbench: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
