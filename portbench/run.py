"""Run one cell of the benchmark of gpuntt_tpu_torch once, on one H100.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m portbench.run ...`), from the root of a checkout.  The
last line of standard output is the result: {"correct", "attempted",
"failed", "metrics", "device"[, "breakdown"], "check"}.  With --trace 0
the metrics are the cell's end-to-end metrics, with --trace 1 its
per-layer ones, read from a profiled slice of calls after the window.
The numbers the check compared, each beside its limit, are the last
lines of standard error and the result's last key.

Exits 2 without a result where torch sees no CUDA card or fewer than
the cell asks for, and 3 where a module of JAX or of the JAX package is
loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
_REPO = _HERE.parent
# run as a script, this folder heads sys.path: take it off, so that its
# modules are only ever loaded as parts of the package
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
if str(_REPO) not in sys.path:
    sys.path.insert(0, str(_REPO))

import torch  # noqa: E402

from portbench import harness  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gpuntt_tpu"})


def forbidden_modules(names=None) -> list:
    """The modules among `names` (default: those loaded) whose top-level
    name, the part before the first dot compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in (sys.modules if names is None else names)
                  if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else None


def result(bench: dict, name: str, rec: dict, trace_run: bool, device) -> dict:
    metrics = {}
    for m in harness.metrics_of(bench, name, trace_run):
        value = harness.module("metrics", m["name"]).read(rec)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": harness.cell(bench, name)["chips"],
           "memory_peak_bytes": rec["memory_peak_bytes"], "power_limit": _power_limit()}
    out = {"correct": rec["correct"], "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    if trace_run:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["check"] = rec["check"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of a build or kernel compile stays inside the checkout;
    # each is read at first use, after this
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(_HERE / "out" / "cache" / sub)

    bench = harness.benchmark()
    chips = harness.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    rec = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace), device,
                          T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    out = result(bench, args.workload, rec, bool(args.trace), device)
    print(f"portbench: {args.workload} seed {args.seed}: {rec['attempted']} calls, "
          f"setup {rec['setup_s']:.3f} s, check {rec['check_s']:.3f} s", file=sys.stderr)
    for key, c in rec["check"].items():
        bound = f"max {c['max']}" if "max" in c else f"min {c['min']}"
        print(f"check {key} {c['value']} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
