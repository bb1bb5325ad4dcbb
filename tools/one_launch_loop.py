#!/usr/bin/env python3
"""Repeat the card test ``test_global_scale_cuda_one_launch`` and two
instrumented forms of it, to tell a profiler that drops an event from a
global-scale launch that does not run.

    PYTHONPATH=src python3 tools/one_launch_loop.py [--runs 300]

``test``: the test itself, ``--runs`` times; its failures and the number
of device events its traces held.  ``wrapper``: the same three calls of
``global_scale_cuda`` on a fresh stack each run (a new scale each run),
after three blocks holding -7 were freed for its outputs to reuse, with
host-side launch events traced too; every output is checked.  ``entry``:
the three calls through the kernel's C entry into outputs prefilled with
-7.  A launch that did not run leaves -7 or a stale scale in its output;
a dropped event leaves every output right with fewer than three kernel
events in the trace.  Both instrumented forms also check that the
per-device scratch is zero after each run.  Prints one JSON line of
counts last; exits 1 if any launch did not run or the scratch was left
dirty.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=300)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import quant
    from repro_torch.kernels import _build
    from repro_torch.kernels import quantize_fp4 as qk
    from test_torch_cuda import test_global_scale_cuda_one_launch

    if not torch.cuda.is_available():
        print("one_launch_loop: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "runs": args.runs,
           "test_failures": 0, "test_event_counts": {}}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for i in range(args.runs):
            try:
                test_global_scale_cuda_one_launch(dev, Path(tmp))
            except AssertionError as e:
                out["test_failures"] += 1
                print(f"test run {i}: {e}", flush=True)
            events = json.loads((Path(tmp) / "trace.json").read_text())[
                "traceEvents"]
            key = str(sum(1 for e in events if e.get("cat") in (
                "kernel", "gpu_memset", "gpu_memcpy")))
            out["test_event_counts"][key] = \
                out["test_event_counts"].get(key, 0) + 1

        fn = _build.entry("quantize_fp4", qk._SCALE_ENTRY[torch.bfloat16],
                          qk._SCALE_ARGTYPES)
        stream = torch.cuda.current_stream(dev).cuda_stream
        gen = torch.Generator(device=dev).manual_seed(0)

        def entry_calls(w, scratch):
            outs = [torch.full((1,), -7.0, device=dev) for _ in range(3)]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for o in outs:
                    _build.check(fn(w.data_ptr(), None, scratch.data_ptr(),
                                    o.data_ptr(), *w.shape, *w.stride(),
                                    stream), "global_scale_fp4")
                torch.cuda.synchronize()
            return outs, prof

        def wrapper_calls(w, scratch):
            junk = [torch.full((1,), -7.0, device=dev) for _ in range(3)]
            torch.cuda.synchronize()
            del junk                         # blocks the outputs reuse
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                outs = [qk.global_scale_cuda(w) for _ in range(3)]
                torch.cuda.synchronize()
            return outs, prof

        for form, calls in (("wrapper", wrapper_calls),
                            ("entry", entry_calls)):
            stats = {"short_traces": 0, "missing_launches": 0,
                     "dirty_scratch": 0, "kernel_events": {},
                     "host_launch_events": {}}
            for i in range(args.runs):
                w = (torch.randn(4, 64, 96, generator=gen, device=dev)
                     * float(torch.rand((), generator=gen, device=dev)
                             * 100 + 1e-3)).to(torch.bfloat16)
                want = quant.global_scale_for(w).reshape(1)
                qk.global_scale_cuda(w)            # the scratch exists
                scratch = qk._scale_scratch[w.device]
                outs, prof = calls(w, scratch)
                path = Path(tmp) / "loop.json"
                prof.export_chrome_trace(str(path))
                trace = json.loads(path.read_text())["traceEvents"]
                events = [e for e in trace if e.get("cat") in (
                    "kernel", "gpu_memset", "gpu_memcpy")]
                launches = [e for e in trace if e.get("cat") == "cuda_runtime"
                            and "LaunchKernel" in e.get("name", "")]
                for key, n in (("kernel_events", len(events)),
                               ("host_launch_events", len(launches))):
                    stats[key][str(n)] = stats[key].get(str(n), 0) + 1
                ran = [torch.equal(o.reshape(1).view(torch.int32),
                                   want.view(torch.int32)) for o in outs]
                if len(events) != 3:
                    stats["short_traces"] += 1
                    print(f"{form} run {i}: {len(events)} kernel events, "
                          f"{len(launches)} host launch events, outputs "
                          f"right: {ran}", flush=True)
                if not all(ran):
                    stats["missing_launches"] += 1
                    print(f"{form} run {i}: outputs "
                          f"{[float(o) for o in outs]}, want {float(want)}",
                          flush=True)
                if bool(scratch.any()):
                    stats["dirty_scratch"] += 1
                    scratch.zero_()
            out[form] = stats
    print(json.dumps(out))
    bad = any(out[f]["missing_launches"] or out[f]["dirty_scratch"]
              for f in ("wrapper", "entry"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
