"""The benchmark of cmdlmc_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` (rows the driver emitted in the window), ``failed`` (rows
with a value that is not finite), ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``), with
``--trace 1`` the ``breakdown``, and last ``checks``: each number the
comparison with the plain reference computed, beside its limit. The same
numbers close standard error. Exits with 2, printing no result, without a
CUDA device (or fewer than the cell asks for), and with 3 if the port
loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / "benchmark" / "_work" / "cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")

    import torch

    from benchmark import harness

    spec = harness.load_spec(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec["chips"]):
        print(f"needs {spec['chips']} CUDA device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                               T_START, log=print)
    except harness.ForbiddenModules as exc:
        print(f"the run loaded {', '.join(exc.args[0])}: the benchmark's process must "
              "not hold JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
