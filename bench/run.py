"""The benchmark of ``repro_torch``, the simulator's PyTorch and CUDA port.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on one CUDA card, from the root of a
checkout, and prints one JSON result as the last line of standard output.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window.  Exits non-zero with no result
where there is no card, the port is missing, or a module of JAX or of the
JAX package was loaded.  See ``bench/README.md``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # The port builds its kernels under build/ in the checkout; nothing else
    # of this run caches outside it.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch

    import harness

    chips = int(harness.resolve_cell(ROOT, args.workload).entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)

    result, checks = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                      bool(args.trace), T_START)
    return harness.print_result(result, checks)


if __name__ == "__main__":
    sys.exit(main())
