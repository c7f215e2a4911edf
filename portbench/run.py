"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Needs a CUDA card (and as many as the cell
asks for); without one it prints no result and exits with 2. The last line
of standard output is the result's JSON object; the numbers the output
check compared, each beside its limit, are the last lines of standard
error and the result's last key.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    from portbench import harness
    chips = harness.load_cell(args.workload, args.seed).chips
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda", t_start=_T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
