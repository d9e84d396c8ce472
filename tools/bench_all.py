"""Run every BASELINE bench config under both solvers into one JSON file.

Each run is a child process (``bench.py --config C --solver S``), one at a
time, so only one process holds the card; this parent never imports JAX.

Usage: python tools/bench_all.py [--out bench_all.json] [--configs 1 2 3]
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="bench_all.json")
    ap.add_argument("--configs", type=int, nargs="*", default=[1, 2, 3, 4, 5])
    ap.add_argument("--timeout", type=int, default=5400)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    results = {}
    for c in args.configs:
        for solver in ("sor", "pcg"):
            t0 = time.time()
            r = subprocess.run(
                [sys.executable, os.path.join(REPO, "bench.py"), "--config",
                 str(c), "--solver", solver],
                capture_output=True, timeout=args.timeout, cwd=REPO,
                text=True)
            line = [ln for ln in r.stdout.strip().splitlines()
                    if ln.startswith("{")]
            entry = json.loads(line[-1]) if (r.returncode == 0 and line) else {
                "error": (r.stderr or r.stdout)[-2000:]}
            entry["wall_s"] = round(time.time() - t0, 1)
            key = f"config{c}" if solver == "sor" else f"config{c}_pcg"
            results[key] = entry
            print(f"config {c} [{solver}]: {entry}", flush=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
