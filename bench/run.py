"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Progress goes to standard error; the last
line of standard output is one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), and last ``compared``: each number compared with the plain
reference beside its limit, which also close standard error.

Exit codes: 0 a result was printed (``correct`` may be false); 2 bad
arguments; 3 no card, or fewer than the cell asks for; 4 the program
(``src/repro_torch``) is not in the checkout; 5 JAX or the JAX package was
loaded; 1 anything else.  Only exit code 0 prints a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "bench" / ".cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    """Parse the arguments, run the cell, print the result line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def say(msg):
        print(msg, file=sys.stderr, flush=True)

    if not (ROOT / "src" / "repro_torch").is_dir():
        say(f"[bench] the program is not in this checkout: "
            f"{ROOT / 'src' / 'repro_torch'} is missing")
        return 4
    from bench.harness import runner
    try:
        result = runner.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), t_start=T_START, log=say)
    except runner.NoChip as e:
        say(f"[bench] no result: {e}")
        return 3
    except runner.Forbidden as e:
        say(f"[bench] no result: {e}")
        return 5
    except Exception:                           # noqa: BLE001 — exit code
        say(traceback.format_exc())
        return 1
    for name, c in result["compared"].items():
        rel = ">=" if c.get("at_least") else "<="
        say(f"compared {name} {c['value']} limit {rel} {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
