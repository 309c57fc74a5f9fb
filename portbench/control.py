"""The control of the check: the reference computed with float64 quotients
(reference.modpoly.mulmod_f64) put in the program's place, run through
the harness like any run of the cell.  The check must come out false.

    python3 portbench/control.py --workload <name> --seconds 2 --seeds 1 2 3

prints one JSON line a seed: the numbers the check compared.  Runs on
the card the cells ask for; warm-up is one call, since the control is
not timed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
if str(_HERE.parent) not in sys.path:
    sys.path.insert(0, str(_HERE.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import modpoly  # noqa: E402


class Control:
    """An entry adapter whose calls are the float64 reference."""

    def __init__(self, entry, cfg: dict, tr: dict):
        self.entry, self.cfg, self.tr = entry, cfg, tr
        self.build, self.operands_pool = entry.build, entry.operands_pool
        self.counts, self.reference = entry.counts, entry.reference

    def call(self, state, pool, i):
        return self.entry.reference(self.cfg, self.tr, pool, i, modpoly.mulmod_f64)


def spec(name: str) -> dict:
    s = harness.cell_spec(name)
    s["traffic"]["warmup_calls"] = 1
    s["entry"] = Control(s["entry"], s["config"], s["traffic"])
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        rec = harness.execute(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                              time.perf_counter(), spec=spec(args.workload))
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": rec["correct"],
                          "attempted": rec["attempted"], "check": rec["check"],
                          "check_s": rec["check_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
