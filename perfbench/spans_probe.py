"""The program's spans in any cell, beyond what `BENCHMARK.json` reads: a
traced run of the cell under the `program_spans` driver (its mix's own
driver inside) with every span reader and the device-idle time inside
each span; or a whole untraced window with the program's recorder on or
off throughout (what the recorder costs); or the recorder's cost per
span on this host.

    python3 perfbench/spans_probe.py trace <cell> <seed> [options]
    python3 perfbench/spans_probe.py window <cell> <seed> on|off [options]
    python3 perfbench/spans_probe.py ns

Options: `--bench FILE` takes the cell from another benchmark file (the
t2i serving cell: `perfbench/tests/_bench_all.json`), `--mix NAME` runs
it on `traffic/NAME.json` (`t2i-offline-512pairs-checked`, its mix with
a limit), `--tiny` at its test size on the CPU. Prints one JSON line.
Needs the card, except with `--tiny`. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import time

STARTED = time.time()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

READERS = ["serve.decode_launch_ms", "serve.loop_self_ms",
           "serve.harvest_wait_ms", "serve.idle_in_decode_share",
           "t2i_serve.admit_host_ms", "t2i_serve.idle_in_admit_share",
           "train.forward_host_ms", "train.backward_host_ms",
           "train.update_host_ms", "train.idle_in_fwd_bwd_share"]


def make_run(cell: str, seed: int, seconds: float, trace: bool, opts):
    import torch

    from perfbench import harness
    bench = str(ROOT / opts.get("--bench", "BENCHMARK.json"))
    if "--tiny" in opts:
        from perfbench.tests.tiny import tiny_run
        r = tiny_run(cell, seed=seed, seconds=seconds, trace=trace,
                     bench=bench)
    else:
        r = harness.Run(harness.find_cell(cell, Path(bench)), seed, seconds,
                        trace, torch.device("cuda", 0), STARTED)
    if "--mix" in opts:
        r.cell.traffic = harness.load_json(
            harness.BENCH_DIR / "traffic" / f"{opts['--mix']}.json")
    t = r.cell.traffic
    if t["driver"] != "program_spans":
        r.cell.traffic = dict(t, driver="program_spans", inner=t["driver"])
    return r


def by_span(trace) -> dict:
    """For each span name: count, host ms, self ms and the device-idle ms
    inside it; and the idle outside every top-level span."""
    from perfbench.metrics import _program
    rec = trace.facts.get("program_spans") or []
    out = {n: {"count": _program.count(rec, n),
               "host_ms": _program.total_us(rec, n) / 1e3,
               "self_ms": _program.self_us(rec, n) / 1e3,
               "idle_ms": 1e3 * _program.idle_within_s(trace, rec, n)}
           for n in sorted({r[0] for r in rec})}
    top = {r[0] for r in rec if r[3] is None}
    out["idle_outside_ms"] = 1e3 * (trace.window_s - trace.busy_s()
                                    - _program.idle_within_s(trace, rec,
                                                             *top))
    return out


def main(argv) -> None:
    from llamagen_tpu_torch.utils import profiling
    from perfbench import harness
    from perfbench.drivers import program_spans

    flags = [i for i, a in enumerate(argv) if a.startswith("--")]
    opts = {argv[i]: (argv[i + 1] if argv[i] != "--tiny" else True)
            for i in flags}
    mode, tiny = argv[0], "--tiny" in opts
    if mode == "ns":
        res = {}
        for on in (False, True):
            n = 200_000
            if on:
                profiling.enable()
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with profiling.span("x", rows=1):
                    pass
            res["on" if on else "off"] = (time.perf_counter_ns() - t0) / n
            profiling.disable()
        print(json.dumps({"ns_per_span": res}))
        return
    cell, seed = argv[1], int(argv[2])
    if mode == "trace":
        r = make_run(cell, seed, 10.0, True, opts)
        out = program_spans.run(r)
        names = READERS + [m["name"] for m in r.cell.per_layer]
        vals = {m: harness.metric_reader(m)(out.trace) for m in names}
        line = {"cell": cell, "seed": seed, "correct": out.correct,
                "device": out.device,
                "metrics": {k: v for k, v in vals.items() if v is not None},
                "window_s": out.trace.window_s,
                "busy_s": out.trace.busy_s(), "spans": by_span(out.trace),
                "harness": out.trace.breakdown()}
    else:
        on = argv[3] == "on"
        r = make_run(cell, seed, 0.5 if tiny else 50.0, False, opts)
        if on:
            profiling.enable()
        out = program_spans.run(r)
        line = {"cell": cell, "seed": seed, "recorder": on,
                "spans": len(profiling.spans()) if on else 0,
                "correct": out.correct, "metrics": out.metrics}
        profiling.disable()
    print(json.dumps(line, default=float))


if __name__ == "__main__":
    main(sys.argv[1:])
