"""Runs one cell of the benchmark once, on the card of the machine it is
started on, and prints its result as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The workload names a configuration and a traffic mix in BENCHMARK.json
(benchmark/README.md). Exit codes: 0 with a result line (whether or not
`correct`); 2 bad arguments or an unknown workload; 3 no card, or fewer
than the cell asks for; 4 the program (hessgpu_tpu_torch) is not in the
checkout; 5 JAX or the JAX package was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _caches() -> None:
    """Kernel and bytecode caches at fixed paths inside the checkout (the
    program builds its own kernels into hessgpu_tpu_torch/build/, also
    inside it). Where the environment forbids writing bytecode beside the
    sources (PYTHONDONTWRITEBYTECODE), every run would compile torch's
    Python anew, some 6 s of set-up: the bytecode of all that the run
    imports is kept under the checkout instead, so that only its first run
    compiles it."""
    base = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    sys.pycache_prefix = str(base / "pyc")
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(BENCH_DIR))
    from benchlib import manifest

    try:
        c = manifest.cell(args.workload, ROOT)
    except (KeyError, FileNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < c.chips:
        print(f"benchmark: the cell needs {c.chips} CUDA card(s), "
              f"{cards} available", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    return run_and_report(c, args.seed, args.seconds, bool(args.trace),
                          device="cuda")


def run_and_report(c, seed: int, seconds: float, traced: bool, device,
                   program_factory=None) -> int:
    """Runs the cell `c` once and prints its result; returns the exit code.
    The look for JAX is the last step before the result is printed, after
    the reference, the stage counts and every metric reader have loaded."""
    from benchlib import cell as bench
    from benchlib.program import Program, ProgramMissing

    try:
        result = bench.run_cell(c, seed, seconds, traced, T_START,
                                device=device, root=ROOT,
                                program_factory=program_factory or Program)
    except ProgramMissing as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    found = bench.forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {found}", file=sys.stderr)
        return 5
    extra = result.pop("extra")
    print(json.dumps({"workload": c.name, "seed": seed, **extra}),
          flush=True)
    for name, chk in result["checks"].items():
        print(f"check {name} = {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
