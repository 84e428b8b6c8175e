"""The CUDA events of one augmentation call (crop + flip), call by call.

Run on the card::

    python3 -m deeplearning4j_tpu_torch.benchmarks.probe_crop_events [--calls N]

It makes the call of ``tests/test_torch_cuda.py::
test_the_crop_launches_a_fixed_number_of_kernels`` — ``DeviceAugmentation
(7).crop(32).random_flip()`` on uint8 [B, 3, 256, 256] to 224^2, B in 2
and 64 — ``N`` times for each batch, each call alone under
``torch.profiler``, as the test profiles it, with the CPU activity on
too. It prints, for each batch, how many calls saw each multiset of CUDA
event names, and the names by which a rarer multiset differs from the
commonest, split into kernels and the memory operations
(``Memcpy``/``Memset``) the runtime records beside them, and beside each
multiset the kernel launches the CUDA runtime reported on the calling
thread (``cudaLaunchKernel*``/``cuLaunchKernel*`` events), which the
profiler records as they happen rather than from the device's activity
buffers; the last line is one JSON object with the same counts.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys


def _is_memory_op(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _is_launch(name: str) -> bool:
    return name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))


def probe(calls: int) -> dict:
    import torch

    from deeplearning4j_tpu_torch.nn.augment import DeviceAugmentation
    dev = torch.device("cuda")
    aug = DeviceAugmentation(7).crop(32).random_flip()
    t = torch.tensor(3, dtype=torch.int32, device=dev)
    out = {}
    for b in (2, 64):
        x = torch.randint(0, 256, (b, 3, 256, 256), dtype=torch.uint8,
                          device=dev)
        aug.apply(x, aug.step_key(t))
        torch.cuda.synchronize()
        seen = collections.Counter()
        launches = collections.defaultdict(collections.Counter)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for _ in range(calls):
            with torch.profiler.profile(activities=acts) as p:
                aug.apply(x, aug.step_key(t))
                torch.cuda.synchronize()
            evs = p.events()
            names = tuple(sorted(
                e.name for e in evs
                if e.device_type == torch.autograd.DeviceType.CUDA))
            seen[names] += 1
            launches[names][sum(
                e.device_type == torch.autograd.DeviceType.CPU
                and _is_launch(e.name) for e in evs)] += 1
        common = seen.most_common(1)[0][0]
        kinds = []
        for names, n in seen.most_common():
            c, m = collections.Counter(names), collections.Counter(common)
            extra, missing = sorted((c - m).elements()), sorted(
                (m - c).elements())
            kinds.append({
                "calls": n, "events": len(names),
                "runtime_launches": dict(launches[names]),
                "kernels": sum(not _is_memory_op(s) for s in names),
                "memory_ops": sum(_is_memory_op(s) for s in names),
                "extra_vs_commonest": extra,
                "missing_vs_commonest": missing})
        out[b] = kinds
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m deeplearning4j_tpu_torch.benchmarks."
             "probe_crop_events", description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=100,
                    help="profiled calls for each batch size")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_crop_events: no CUDA device", file=sys.stderr)
        return 1
    res = probe(args.calls)
    for b, kinds in res.items():
        for k in kinds:
            print(f"B={b}: {k['calls']} of {args.calls} calls saw "
                  f"{k['events']} CUDA events ({k['kernels']} kernels, "
                  f"{k['memory_ops']} memory ops), runtime launches "
                  f"{k['runtime_launches']} (count: calls); beside the "
                  f"commonest: +{len(k['extra_vs_commonest'])} "
                  f"-{len(k['missing_vs_commonest'])} "
                  f"{sorted(set(s[:60] for s in k['missing_vs_commonest']))}",
                  flush=True)
    print(json.dumps({"crop_events": {str(b): v for b, v in res.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
