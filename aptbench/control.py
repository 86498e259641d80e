#!/usr/bin/env python3
"""The control of a cell's comparison: the reference itself, computed in
bfloat16 (the precision below the configurations' float32), put in the
program's place and judged as the program's PNGs are, on the cell's own
pool of passes at full size.  It has to come out as not correct.

    python3 aptbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

Prints one JSON line per seed: ``correct``, decided as a run decides it
(``harness.decide``), and the numbers compared beside the cell's limits,
which also go to standard error.  Exits with 1 if the control comes out
correct on any seed, with 0 if it fails on every one.  Needs the card, as
the benchmark does; the benchmark's runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))

from aptbench import harness, spec  # noqa: E402


def control(root: Path, workload: str, seed: int, device: str, workdir: Path) -> dict:
    """The control's ``correct`` and numbers on ``workload``'s pool for ``seed``."""
    import torch

    from aptbench.gen.pool import make_pool, read_wav
    from aptbench.reference import decode as ref_decode

    sp = spec.Spec(root)
    cell = sp.cell(workload)
    config = sp.config(cell["config"])
    passes = make_pool(workdir, seed, config, sp.traffic(cell["traffic"]), torch.device(device))

    def low(p):
        return lambda: ref_decode.decode(read_wav(p.path), p.rate, config["profile"], config["percent"],
                                         dtype=torch.bfloat16, device=device).u8.cpu().numpy()

    checks, correct = harness.decide(harness.compare(config, [(p, low(p)) for p in passes], 0, device),
                                     sp.limits(workload))
    return {"workload": workload, "seed": seed, "control": "bfloat16 reference", "correct": correct,
            "checks": checks}


def main(argv=None) -> int:
    import shutil
    import tempfile

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("aptbench control: CUDA is not available", file=sys.stderr)
        return 2
    passed = []
    for seed in args.seed:
        work = Path(tempfile.mkdtemp(prefix="aptbench-control-"))
        try:
            got = control(ROOT, args.workload, seed, "cuda", work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for name, c in got["checks"].items():
            print(f"control seed {seed}: check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
        print(json.dumps(got), flush=True)
        if got["correct"]:
            passed.append(seed)
    if passed:
        print(f"aptbench control: the control came out correct on seed(s) {passed}: the limits do not "
              "tell it from the program", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
