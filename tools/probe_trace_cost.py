"""What one launch-counting trace costs on the card, apart from the work it
wraps: the profiler's start, its stop, and reading the kernel records, for
traces of 0 to ~100k kernel launches, eager and as CUDA graph replays,
with and without external correlation, and with and without the kineto
config that ``chip_smoke.py`` uses (``dynamic_llava_tpu_torch/kineto.conf``).

    python3 tools/probe_trace_cost.py          # one card

Prints one line a case and a JSON line ``trace_cost`` at the end. Each
configuration runs in a process of its own, since kineto reads its config
once per process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SIZES = (0, 1000, 10000, 100000)
REPEATS = 3


def child() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")

    def work(n):
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()

    work(100)
    # the same 100k kernels as graph replays (few runtime records, as a
    # decode chunk's replays), with and without external correlation
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        work(3)
        with torch.cuda.graph(graph):
            for _ in range(1000):
                x.add_(1)
    torch.cuda.current_stream().wait_stream(stream)

    def replays(n):
        for _ in range(n // 1000):
            graph.replay()
        torch.cuda.synchronize()

    cases = [(f"eager {n}", work, n, {}) for n in SIZES]
    cases += [("graph 100000", replays, 100000, {}),
              ("graph 100000 no external correlation", replays, 100000,
               dict(experimental_config=torch._C._profiler._ExperimentalConfig(
                   disable_external_correlation=True))),
              ("eager 100000 no external correlation", work, 100000,
               dict(experimental_config=torch._C._profiler._ExperimentalConfig(
                   disable_external_correlation=True)))]
    rows = []
    for label, fn, n, kw in cases:
        for rep in range(REPEATS):
            t0 = time.perf_counter()
            prof = profile(activities=[ProfilerActivity.CUDA], **kw)
            prof.__enter__()
            t1 = time.perf_counter()
            fn(n)
            t2 = time.perf_counter()
            prof.__exit__(None, None, None)
            t3 = time.perf_counter()
            seen = Counter(e.name() for e in prof.profiler.kineto_results.events()
                           if e.device_type() == DeviceType.CUDA)
            t4 = time.perf_counter()
            rows.append(dict(case=label, n=n, rep=rep, start_s=t1 - t0, work_s=t2 - t1, stop_s=t3 - t2,
                             read_s=t4 - t3, records=sum(seen.values())))
            print(f"  {label} rep={rep}: start {t1 - t0:.3f} s, work {t2 - t1:.3f} s, "
                  f"stop {t3 - t2:.3f} s, read {t4 - t3:.3f} s, {sum(seen.values())} records",
                  flush=True)
            del prof
    print("rows " + json.dumps(rows), flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child()
        return 0
    out = {}
    for name, conf in (("default", None),
                       ("kineto.conf", str(ROOT / "dynamic_llava_tpu_torch" / "kineto.conf"))):
        env = dict(os.environ)
        env.pop("KINETO_CONFIG", None)
        if conf:
            env["KINETO_CONFIG"] = conf
        print(f"config {name}", flush=True)
        res = subprocess.run([sys.executable, __file__, "--child"], env=env,
                             capture_output=True, text=True, check=True)
        for line in res.stdout.splitlines():
            if line.startswith("rows "):
                out[name] = json.loads(line[5:])
            else:
                print(line, flush=True)
    print("trace_cost " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
