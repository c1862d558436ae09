"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's configuration with weights drawn on the card from
the seed and warms up the cell's own shapes; the window then measures for
``--seconds``; the outputs are checked against the plain reference under
``perfbench/reference/``; the last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each compared number
beside its limit). ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

# every build and kernel cache inside the checkout, at fixed paths (the
# port's own kernels build into multimodal_embeddings_tpu_torch/_build)
CACHE = os.path.join(HERE, "_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", cell=None) -> int:
    """Runs the cell; returns the exit code. ``device`` and ``cell`` are
    for the CPU tests only: a run of the benchmark takes the card."""
    args = parse_args(argv)
    import torch

    from benchlib.cells import load_cell
    from benchlib.guard import forbidden_modules

    cell = cell or load_cell(args.workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"the cell needs {cell.chips} cards, {torch.cuda.device_count()} here",
                  file=sys.stderr)
            return 3
    session = cell.driver().Session(cell, args.seed, device)
    session.setup()
    setup_s = time.perf_counter() - T_START
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run = session.run(args.seconds, bool(args.trace))
    # the bytes the check's own recorder holds all through the window are
    # not the program's
    memory_peak = (torch.cuda.max_memory_allocated() - getattr(session, "memory_offset", 0)
                   if device == "cuda" else 0)
    session.release()
    t_check = time.perf_counter()
    checks = session.check()
    run.notes["check_s"] = time.perf_counter() - t_check
    run.notes.update(getattr(session, "check_notes", {}))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4

    metrics = {}
    if not args.trace:
        values = dict(run.end_to_end, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(value <= limit for _, value, limit in checks)
    dev = {
        "platform": "gpu" if device == "cuda" else device,
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
        "count": cell.chips,
        "memory_peak_bytes": memory_peak,
    }
    if args.trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        result["breakdown"] = run.trace.breakdown()
        run.notes.update({f"family.{k}_s": v for k, v in run.trace.time_by_family().items()})
    result["card"] = card_power_limit() if device == "cuda" else device
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    for key, value in sorted(run.notes.items()):
        print(f"note {key} = {value}", file=sys.stderr)
    for name, value, limit in checks:
        verdict = "ok" if value <= limit else "FAILED"
        print(f"check {name} = {value!r} limit {limit!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
