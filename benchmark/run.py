"""The benchmark of splatloam_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

prints, as its last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), the numbers compared with the plain
reference last under ``checks``, and the same numbers as its last lines
on standard error.  It exits non-zero and prints no result without a
CUDA device, outside a checkout that holds the program, or if JAX or the
JAX package was loaded.  ``--control 1`` puts the TF32 reference in the
program's place and ``--fault <name>`` breaks the timed path
(faults.py): both are for the check that the comparison fails them.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "splatloam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    cache = CHECKOUT / "build" / "benchmark-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    # one host thread for the program's CPU work: the optimize blocks are
    # bound by the host's graph launches, and spare intra-op threads only
    # contend with it for the machine's shared cores
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if not (CHECKOUT / "splatloam_tpu_torch" / "__init__.py").is_file():
        print(f"no splatloam_tpu_torch beside {HERE}", file=sys.stderr)
        return 2

    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(CHECKOUT))
    from manifest import Manifest
    manifest = Manifest(CHECKOUT / "BENCHMARK.json")
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import harness
    result, checks = harness.run_cell(
        manifest, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda", T_START, control=bool(args.control), fault=args.fault)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
