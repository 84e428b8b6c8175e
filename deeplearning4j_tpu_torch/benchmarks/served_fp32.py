"""The served fp32 paths that run the fp32 flash kernel, timed on one tree.

Run on the card, from any directory, once for each tree to compare (a
checkout of this repo, or a ``git archive`` of another commit unpacked
into a git-ignored directory), in one call: parent, change, change,
parent::

    python3 deeplearning4j_tpu_torch/benchmarks/served_fp32.py <tree> <label>

It imports the package and ``chip_smoke.py`` of ``<tree>``, builds that
tree's kernels, runs its ``chip_smoke.import_bert`` (phases 23-24:
path A's captured B=32, T=128 replay, host batch to host answer, and its
train step, each printed by the phase), then imports phase 28's depth-2
Keras encoder with 1024 positions (``keras_fixtures.encoder_h5(path, 1,
P=1024, L=2, T=1024)``), serves it captured and times the [4, 1024]
replay, host batch to host answer, median of 20 after one untimed. Lines
of its own start with ``[<label>]``.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    root, label = os.path.abspath(argv[0]), argv[1]
    os.chdir(root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import chip_smoke as c
    from deeplearning4j_tpu_torch.modelimport import keras_fixtures as kf
    from deeplearning4j_tpu_torch.modelimport.keras import (
        importKerasModelAndWeights)
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.serving import ModelServer

    t0 = time.perf_counter()
    ck.build()
    print(f"[{label}] build {time.perf_counter() - t0:.1f} s", flush=True)
    ck.install_platform_overrides()
    smi = c.smi_line()
    r = c.import_bert(smi)
    print(f"[{label}] path_a {r['path_a']}", flush=True)
    tmp = tempfile.mkdtemp(prefix="served_fp32_")
    try:
        p = os.path.join(tmp, "e.h5")
        kf.encoder_h5(p, 1, P=1024, L=2, T=1024)
        net = importKerasModelAndWeights(p)

        def classify(tokens):
            pos = torch.arange(tokens.shape[1], device=tokens.device,
                               dtype=torch.int32).expand(tokens.shape[0], -1)
            return net.output([tokens, pos])
        xl = np.random.default_rng(0).integers(0, 30522, (4, 1024),
                                               dtype=np.int32)
        server = ModelServer(classify, batch_limit=4, input_dtype=np.int32,
                             coalesce_ms=5.0)
        try:
            ck.reset_counts()
            server.warmup([(1024,)])
            routes = dict(ck.FLASH_ROUTES)
            ts = []
            for _ in range(21):
                t0 = time.perf_counter()
                server._forward_raw(xl)
                ts.append((time.perf_counter() - t0) * 1e3)
        finally:
            server.close()
        med = float(np.median(ts[1:]))
        print(f"[{label}] T=1024 depth-2 captured replay median of 20 "
              f"{med:.3f} ms (min {min(ts[1:]):.3f}, max {max(ts[1:]):.3f}),"
              f" {4 * 1024 / (med / 1e3):.0f} tokens/s; flash routes at "
              f"capture {routes} [{smi}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
