"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a workload of ``BENCHMARK.json`` at the root of the checkout;
see ``benchmark/README.md`` for the files it is made of. The run needs as
many CUDA cards as the cell asks for and exits with code 3, printing no
result, where there are fewer. A cell on N > 1 cards starts its other
N − 1 ranks itself (one process a card, NCCL through a rendezvous on a free
``localhost`` port) and rank 0 prints the result. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number that decided ``correct`` beside its limit, which
also end standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _seconds_since_start():
    """A clock of the seconds since this process started (its start read
    from ``/proc``, in ticks of 10 ms, against the boot clock)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        before = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        before = 0.0
    t0 = time.perf_counter()
    return lambda: before + time.perf_counter() - t0


SINCE_START = _seconds_since_start()
_HERE = os.path.dirname(os.path.abspath(__file__))
# the checkout's root, in place of this file's folder, whose modules would
# otherwise shadow top-level names
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, os.path.dirname(_HERE))

from benchmark import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _caches(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the port's own
    nvcc builds are in ``build/ccnet_tpu_torch``)."""
    build = os.path.join(root, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("CUDA_MODULE_LOADING", "LAZY")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(args, ranks: int) -> list:
    """Start ranks 1 … ranks − 1 of this run, each on its own card."""
    procs = []
    for r in range(1, ranks):
        argv = [sys.executable, os.path.abspath(__file__), "--workload", args.workload,
                "--seed", str(args.seed), "--seconds", str(args.seconds),
                "--trace", str(args.trace), "--rank", str(r), "--port", str(args.port)]
        procs.append(subprocess.Popen(argv, stdout=subprocess.DEVNULL))
    return procs


def _device_info(torch, device, ranks: int, peak: int, stretch) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": ranks,
            "memory_peak_bytes": int(peak)}
    if stretch is not None:
        info["busy_s"] = stretch.busy_s
        info["window_s"] = stretch.window_s
    return info


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, device: str | None = None, root: str = harness.ROOT) -> int:
    """Run a cell; return the exit code. ``device`` and ``root`` are for the
    harness's own tests, which drive a run on the CPU at small sizes from a
    copy of the files: the command line always asks for CUDA cards."""
    args = parse(argv)
    cell = harness.find_cell(args.workload, root)
    _caches(harness.ROOT)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{cell.name} needs {cell.chips} CUDA card(s); {have} visible",
                  file=sys.stderr)
            return 3
        device = f"cuda:{args.rank}"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    procs = []
    if cell.chips > 1:
        # one process a card shares the host's cores: a rank that spreads its
        # host work over all of them contends with the others step by step
        torch.set_num_threads(max(1, (os.cpu_count() or cell.chips) // cell.chips))
        if args.rank == 0:
            args.port = _free_port()
            procs = _spawn_ranks(args, cell.chips)
        os.environ.update({"RANK": str(args.rank), "LOCAL_RANK": str(args.rank),
                           "WORLD_SIZE": str(cell.chips),
                           "LOCAL_WORLD_SIZE": str(cell.chips)})
        torch.distributed.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{args.port}", rank=args.rank,
            world_size=cell.chips)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=dev, rank=args.rank,
                          ranks=cell.chips, setup_clock=SINCE_START)
    try:
        outcome = cell.driver().run(ctx)
    finally:
        if cell.chips > 1 and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        bad = []
        for p in procs:
            try:
                code = p.wait(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                code = p.wait()
            if code:
                bad.append(code)
    if args.rank != 0:
        return 0
    if bad:
        print(f"rank(s) exited with {bad}", file=sys.stderr)
        return 1
    per_layer = harness.read_per_layer(cell, outcome.stretch) if args.trace else None
    info = _device_info(torch, dev, cell.chips, outcome.memory_peak_bytes, outcome.stretch) \
        if dev.type == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 1,
                                    "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result, lines = harness.result_line(cell, outcome, bool(args.trace), info, per_layer)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 4
    if dev.type == "cuda":
        outcome.notes.append(f"card {_power_limit()}")
    for note in outcome.notes:
        print(note, file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
