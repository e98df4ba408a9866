"""Run one cell of the benchmark once.

    python3 rangebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the run's parts and the numbers its
comparison read on standard error, and as the last line of standard output
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number compared with its limit.

Exits non-zero with no result when there is no CUDA card, fewer cards than
the cell asks for, when the program is not beside it, or when the process
holds JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    # the port builds its kernels with nvcc into build/repro_torch/ beside
    # its package; any torch extension or Triton cache goes inside the
    # checkout too, at a fixed place, never under a temporary name
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "rangebench" / sub)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unread"
    except (OSError, subprocess.SubprocessError):
        return "unread"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from rangebench.harness import cell as cells
    from rangebench.harness import spec
    try:
        import torch
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"rangebench: cannot import the program: {e}", file=sys.stderr)
        return 2
    c = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("rangebench: no CUDA card; a measurement needs one", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < c.chips:
        print(f"rangebench: the cell asks for {c.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    try:
        out = cells.run(c, args.seed, args.seconds, bool(args.trace), dev, T_START)
    except RuntimeError:
        traceback.print_exc()
        return 3
    # read after the run, so that set-up does not pay for it
    cells.log(f"[card] {_card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from rangebench.harness import judge
    for name, chk in out["checks"].items():
        rel = ">=" if name in judge.AT_LEAST else "<="
        print(f"check {name} {chk['value']!r} {rel} {chk['limit']!r}", file=sys.stderr)
    print(f"check correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
