"""The port's static cost model (``deeplearning4j_tpu_torch/analysis/
cost.py``) held against the JAX package's.

Given the same chip as a dict of fields, the liveness plan's components
are byte-equal in both packages (fp32, bf16 with masters, a data mesh,
megastep K > 1: the cases of ``tests/test_cost.py``), and the bf16 step
time, capacity and the E120-E122/W120-W122 lints agree. The H100 entry
and its fp32 rule (fp32 runs on the CUDA cores at 67 TFLOP/s, not at half
the tensor-core rate) are pinned. Floats agree to 1e-9 relative: both
packages do the same Python arithmetic.
"""

import re

import numpy as np
import pytest

from deeplearning4j_tpu.analysis import cost as JC
from deeplearning4j_tpu.analysis.chipspec import CHIP_REGISTRY as J_CHIPS
from deeplearning4j_tpu.nn.config import InputType as JIT
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.train import updaters as JU
from deeplearning4j_tpu_torch.analysis import cost as TC
from deeplearning4j_tpu_torch.analysis import analyze
from deeplearning4j_tpu_torch.analysis.chipspec import (CHIP_REGISTRY,
                                                        ChipSpec, chip_names)
from deeplearning4j_tpu_torch.nn.config import InputType as TIT
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.train import updaters as TU

B = 32
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
#: Dense(784->512) + Dense(512->256) + Output(256->10), biases included
P = (784 * 512 + 512) + (512 * 256 + 256) + (256 * 10 + 10)
ACT_ELEMS = 784 + 512 + 256 + 10

#: the JAX package's tpu-v4 entry, as the fields both packages accept
V4 = {"name": "tpu-v4", "peak_flops": 275e12, "hbm_gb": 32.0,
      "hbm_gbps": 1228.0, "ici_gbps": 300.0}
TINY = {"name": "tiny", "peak_flops": 1e12, "hbm_gb": 0.001,
        "hbm_gbps": 10.0, "ici_gbps": 1.0}
ONEGB = {"name": "onegb", "peak_flops": 1e12, "hbm_gb": 1.0,
         "hbm_gbps": 100.0, "ici_gbps": 10.0}
SLOWICI = {"name": "slowici", "peak_flops": 1e12, "hbm_gb": 32.0,
           "hbm_gbps": 1000.0, "ici_gbps": 0.001}


def _mlp(NNC, L, U, IT, updater=None):
    return (NNC.Builder().seed(7)
            .updater(updater or U.Adam(1e-3)).weightInit("xavier").list()
            .layer(L.DenseLayer(nOut=512, activation="relu"))
            .layer(L.DenseLayer(nOut=256, activation="relu"))
            .layer(L.OutputLayer(nOut=10, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(IT.feedForward(784)).build())


def jmlp():
    return _mlp(JNNC, JL, JU, JIT)


def tmlp():
    return _mlp(TNNC, TL, TU, TIT)


def _findings(diags):
    """(code, severity, location, the numbers in the message): the port
    says "interconnect" where the JAX package says "ICI"."""
    return [(d.code, d.severity, d.location, _NUMBER.findall(d.message))
            for d in diags]


def _close(a, b):
    return a == pytest.approx(b, rel=1e-9, abs=0)


# ------------------------------------------------------------- the registry
def test_h100_entry_and_default():
    h = CHIP_REGISTRY["h100-sxm"]
    assert (h.peak_flops, h.fp32_peak_flops) == (989e12, 67e12)
    assert (h.hbm_gb, h.hbm_gbps, h.ici_gbps, h.host_gbps) == \
        (74.5, 3350.0, 450.0, 64.0)
    assert ChipSpec.coerce(None) is h
    assert TC.CostSpec().chip is h
    assert set(chip_names()) == {"h100-sxm", "cpu"}
    with pytest.raises(ValueError, match="h100-sxm"):
        ChipSpec.coerce("tpu-v4")


def test_fp32_reads_the_specs_own_peak():
    """Hopper rule: fp32 with TF32 off runs on the CUDA cores at 67
    TFLOP/s against 989 for bf16 — 1/14.8 of the tensor-core rate, not
    the half that ``chipspec.peak_for`` gives on the MXU (JAX verdict
    replaced: tpu-v4's fp32 peak = 137.5e12 = 275e12 / 2)."""
    h = CHIP_REGISTRY["h100-sxm"]
    assert h.peak_for("fp32") == h.peak_for("float32") == 67e12
    assert h.peak_for("bf16") == h.peak_for("float16") == 989e12
    assert J_CHIPS["tpu-v4"].peak_for("fp32") == 275e12 / 2
    # a spec with no fp32 field runs fp32 at its one peak; the cpu
    # stand-in keeps the JAX package's halving as explicit fields
    assert ChipSpec.coerce(V4).peak_for("fp32") == 275e12
    assert CHIP_REGISTRY["cpu"].peak_for("fp32") == \
        J_CHIPS["cpu"].peak_for("fp32")


def test_fp32_step_time_uses_the_fp32_peak():
    """The same fp32 MLP step is predicted 989/67 times slower in compute
    on the H100 than bf16-rate arithmetic would give."""
    fp32 = TC.step_time(tmlp(), cost=TC.CostSpec(), batch_size=4096)
    flat = TC.step_time(tmlp(), cost=TC.CostSpec(
        chip=dict(name="flat", peak_flops=989e12, hbm_gb=74.5,
                  hbm_gbps=3350.0, ici_gbps=450.0)), batch_size=4096)
    assert _close(fp32.compute_s, flat.compute_s * 989 / 67)


# ------------------------------------------------- memory plan, byte-equal
MEMORY_CASES = {
    "fp32": dict(cost=dict(chip=V4)),
    "bf16": dict(cost=dict(chip=V4, precision="bf16")),
    "data_mesh": dict(cost=dict(chip=V4), mesh="data=8"),
    "megastep_k16": dict(cost=dict(chip=V4, steps_per_dispatch=16,
                                   prefetch=0)),
    "megastep_k4_bf16_mesh": dict(cost=dict(chip=V4, steps_per_dispatch=4,
                                            precision="bf16"),
                                  mesh="data=4"),
}


@pytest.mark.parametrize("name", sorted(MEMORY_CASES))
def test_memory_plan_components_byte_equal(name):
    kw = MEMORY_CASES[name]
    j = JC.memory_plan(jmlp(), cost=JC.CostSpec(**kw["cost"]),
                       mesh=kw.get("mesh"), batch_size=B)
    t = TC.memory_plan(tmlp(), cost=TC.CostSpec(**kw["cost"]),
                       mesh=kw.get("mesh"), batch_size=B)
    assert t.components == j.components
    assert t.peak_bytes == j.peak_bytes == sum(t.components.values())
    assert t.dominating() == j.dominating()


def test_memory_plan_matches_the_hand_count():
    mem = TC.memory_plan(tmlp(), batch_size=B)
    assert mem.components == {
        "params": P * 4, "grads": P * 4, "fp32 masters": 0,
        "updater state": P * 4 * 2, "live activations": B * ACT_ELEMS * 4,
        "megastep staging": 0, "prefetch": 2 * B * 784 * 4}
    bf16 = TC.memory_plan(tmlp(), cost=TC.CostSpec(precision="bf16"),
                          batch_size=B)
    assert bf16.components["fp32 masters"] == P * 4
    assert bf16.components["params"] == P * 2


def test_memory_plan_equal_on_zoo_resnet50():
    """A whole zoo graph, lowered by each package from the same config."""
    from deeplearning4j_tpu.models import zoo as jz
    from deeplearning4j_tpu_torch.models import zoo as tz
    j = JC.memory_plan(jz.ResNet50().conf_builder(),
                       cost=JC.CostSpec(chip=V4, precision="bf16",
                                        steps_per_dispatch=4),
                       batch_size=64)
    t = TC.memory_plan(tz.ResNet50().conf_builder(),
                       cost=TC.CostSpec(chip=V4, precision="bf16",
                                        steps_per_dispatch=4),
                       batch_size=64)
    assert t.components == j.components


# ------------------------------------------------ roofline, bf16 agreement
STEP_CASES = {
    "alone": dict(),
    "data_mesh": dict(mesh="data=8"),
    "pipeline": dict(mesh={"pipe": 2}, pipeline=True),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_step_time_agrees_for_bf16(name):
    kw = dict(STEP_CASES[name])

    def est(C, conf):
        mesh = kw.get("mesh")
        if kw.get("pipeline"):
            mesh = (JC if C is JC else TC)._dist.MeshSpec({"pipe": 2},
                                                          pipeline=2)
        return C.step_time(conf, cost=C.CostSpec(chip=V4, precision="bf16"),
                           mesh=mesh, batch_size=B)
    j, t = est(JC, jmlp()), est(TC, tmlp())
    for field in ("step_s", "roofline_s", "compute_s", "hbm_s",
                  "collective_s", "mfu"):
        assert _close(getattr(t, field), getattr(j, field)), field
    assert t.bound == j.bound
    if j.per_stage is not None:
        assert all(_close(a, b) for a, b in zip(t.per_stage, j.per_stage))


def test_capacity_agrees_for_bf16():
    j = JC.capacity(jmlp(), JC.CostSpec(chip=V4, precision="bf16",
                                        buckets=(8,), qps=1000.0))
    t = TC.capacity(tmlp(), TC.CostSpec(chip=V4, precision="bf16",
                                        buckets=(8,), qps=1000.0))
    assert set(t) == set(j)
    for k in j:
        assert _close(t[k], j[k]), k
    assert t["min_replicas"] == int(np.ceil(1000.0 / t["per_replica_qps"]))


LINT_CASES = {
    "e120": (dict(chip=TINY), dict(batch_size=B), ["DL4J-E120"]),
    "clean": (dict(chip=V4), dict(batch_size=B), []),
    "w120": (dict(chip=ONEGB, prefetch=0), dict(batch_size=200_000),
             ["DL4J-W120"]),
    "w121": (dict(chip=SLOWICI), dict(mesh="data=8", batch_size=256),
             ["DL4J-W121"]),
    "w121_needs_batch": (dict(chip=SLOWICI), dict(mesh="data=8"), []),
    "w122": (dict(chip=V4, mfu_target=0.99), dict(batch_size=B),
             ["DL4J-W122"]),
    "w122_clean": (dict(chip=V4, mfu_target=1e-9), dict(batch_size=B), []),
    "e121": (dict(chip=TINY, buckets=(8, 1024)), {},
             ["DL4J-E120", "DL4J-E121"]),
    "e121_clean": (dict(chip=V4, buckets=(8, 1024)), {}, []),
    "e122_qps": (dict(chip=V4, qps=1e12, buckets=(8,)), {}, ["DL4J-E122"]),
    "e122_latency": (dict(chip=V4, p99_ms=1e-9), {}, ["DL4J-E122"]),
    "e122_clean": (dict(chip=V4, qps=1.0, p99_ms=1e6, buckets=(8,)), {},
                   []),
}


@pytest.mark.parametrize("name", sorted(LINT_CASES))
def test_lint_cost_agrees_for_bf16(name):
    spec, kw, want = LINT_CASES[name]
    spec = dict(spec, precision="bf16")
    j = JC.lint_cost(jmlp(), JC.CostSpec(**spec), **kw)
    t = TC.lint_cost(tmlp(), TC.CostSpec(**spec), **kw)
    assert [d.code for d in j] == want
    assert _findings(t) == _findings(j)


def test_cost_supersedes_the_params_only_heuristics():
    conf = (TNNC.Builder().seed(7).updater(TU.Adam(1e-3))
            .weightInit("xavier").list()
            .layer(TL.DenseLayer(nOut=4096, activation="relu"))
            .layer(TL.DenseLayer(nOut=4096, activation="relu"))
            .layer(TL.OutputLayer(nOut=10, lossFunction="mcxent"))
            .setInputType(TIT.feedForward(4096)).build())
    assert "DL4J-W109" in analyze(conf, mesh="data=8").codes()
    costed = analyze(conf, mesh="data=8", cost="h100-sxm")
    assert not {"DL4J-W109", "DL4J-E104"} & set(costed.codes())
    assert costed.ok(warnings_as_errors=True), costed.format()
    assert analyze(tmlp(), cost=True).ok()
    assert analyze(tmlp(), cost={"chip": "cpu"}).ok()
    assert "DL4J-E120" in analyze(tmlp(), cost=TC.CostSpec(chip=TINY),
                                  batch_size=B).codes()


def test_plan_report_and_pruner():
    rep = TC.plan(tmlp(), cost=TC.CostSpec(qps=100.0, buckets=(8,)),
                  batch_size=B)
    out = rep.format()
    for text in ("step-peak HBM", "predicted step", "QPS/replica"):
        assert text in out
    toy = {"name": "toy", "peak_flops": 1e12, "hbm_gb": 40.0 / 1024,
           "hbm_gbps": 100.0, "ici_gbps": 10.0}
    pruner = TC.plan_pruner(tmlp(), 1024, {"chip": toy})

    class Plan:
        def __init__(self, k):
            self.steps_per_dispatch, self.prefetch = k, 0
            self.precision = None
    reason = pruner(Plan(16))
    assert "OOM" in reason and "megastep staging" in reason
    assert pruner(Plan(1)) is None
    j_reason = JC.plan_pruner(jmlp(), 1024, {"chip": toy})(Plan(16))
    assert reason == j_reason
