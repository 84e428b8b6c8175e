"""``python -m deeplearning4j_tpu_torch.analysis``: the port's analyzer CLI
on the CPU, and its concurrency lints held against the JAX package's.

The CLI lints the port's zoo, a model by name, a seeded bad module, the
cost model for the H100, ONNX files read by the port's importer,
recorded SameDiff graphs and source files. The concurrency fixtures of
``tests/test_analysis.py`` give the same findings in both packages, the
port lints itself clean, and a ``--zoo`` run with no visible card
allocates no parameter.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from deeplearning4j_tpu.analysis.concurrency import \
    analyze_concurrency as j_concurrency
from deeplearning4j_tpu_torch.analysis.__main__ import main
from deeplearning4j_tpu_torch.analysis.concurrency import \
    analyze_concurrency as t_concurrency
from deeplearning4j_tpu_torch.modelimport import onnx_proto as P

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_zoo_lints_clean(capsys):
    assert main(["--zoo"]) == 0
    assert "16 model(s) linted: 16 clean" in capsys.readouterr().out


def test_zoo_lints_clean_under_mesh_and_cost(capsys):
    assert main(["--zoo", "--mesh", "data=8", "--zero"]) == 0
    assert "16 model(s) linted: 16 clean" in capsys.readouterr().out
    assert main(["--zoo", "--mesh", "data=8", "--cost",
                 "--chip", "h100-sxm"]) == 0
    assert "16 model(s) linted: 16 clean" in capsys.readouterr().out


def test_single_model_by_name(capsys):
    assert main(["LeNet"]) == 0
    assert "LeNet: clean" in capsys.readouterr().out


def test_cost_for_the_h100(capsys):
    assert main(["--cost", "--chip", "h100-sxm", "ResNet50"]) == 0
    assert "ResNet50: clean" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["LeNet", "--chip", "tpu-v4"])
    assert "known chips" in capsys.readouterr().err


BAD_MODULE = (
    "from deeplearning4j_tpu_torch.nn.config import (InputType,\n"
    "    NeuralNetConfiguration)\n"
    "from deeplearning4j_tpu_torch.nn.layers import DenseLayer, "
    "OutputLayer\n"
    "conf = (NeuralNetConfiguration.Builder().list()\n"
    "        .layer(DenseLayer(nIn=300, nOut=16))\n"
    "        .layer(OutputLayer(nOut=4))\n"
    "        .setInputType(InputType.feedForward(128))\n"
    "        .build())\n")


def test_findings_fail_the_exit_code(capsys, tmp_path, monkeypatch):
    (tmp_path / "torch_badmodel.py").write_text(BAD_MODULE)
    monkeypatch.syspath_prepend(str(tmp_path))
    assert main(["torch_badmodel:conf"]) == 1
    assert "DL4J-E001" in capsys.readouterr().out
    assert main(["torch_badmodel"]) == 1          # module scan finds it
    capsys.readouterr()


def test_usage_errors(capsys):
    for argv in (["LeNet", "--suppress", "W999"],
                 ["LeNet", "--severity", "W101=loud"],
                 ["LeNet", "--hbm-gb", "1"],
                 ["LeNet", "--policy", "float8"],
                 ["LeNet", "--data-range", "255"],
                 ["LeNet", "--pipeline", "wrkrs=1"]):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 2, argv
    capsys.readouterr()


def test_policy_range_and_pipeline_flags(capsys, tmp_path, monkeypatch):
    assert main(["LeNet", "--policy", "bf16"]) == 1     # 500: bf16 rows
    out = capsys.readouterr().out
    assert "DL4J-W101" in out and "DL4J-E303" not in out
    assert main(["LeNet", "--policy", "fp16"]) == 1
    assert "DL4J-E303" in capsys.readouterr().out
    assert main(["TinyYOLO", "--data-range", "0..255"]) == 1
    assert "DL4J-W303" in capsys.readouterr().out
    assert main(["LeNet", "--mesh", "data=8", "--batch-size", "6"]) == 1
    assert "DL4J-E101" in capsys.readouterr().out
    assert main(["VGG16", "--mesh", "data=8", "--hbm-gb", "0.01"]) == 1
    assert "DL4J-E104" in capsys.readouterr().out
    assert main(["LeNet", "--pipeline", "workers=1,batch=256,decode_ms=50",
                 "--suppress", "W108"]) == 0
    capsys.readouterr()


def _onnx(nodes, inputs, outputs, initializers=()):
    return P.encode_model(
        nodes,
        [P.encode_value_info(n, dt, s) for n, dt, s in inputs],
        [P.encode_value_info(n, dt, s) for n, dt, s in outputs],
        [P.encode_tensor(n, a) for n, a in initializers])


def _resnet_ish(classes):
    rng = np.random.RandomState(0)
    return _onnx(
        nodes=[P.encode_node("Conv", ["x", "w"], ["c"], kernel_shape=[3, 3],
                             strides=[2, 2], pads=[1, 1, 1, 1]),
               P.encode_node("Relu", ["c"], ["r"]),
               P.encode_node("GlobalAveragePool", ["r"], ["g"]),
               P.encode_node("Flatten", ["g"], ["f"]),
               P.encode_node("Gemm", ["f", "fcw", "fcb"], ["y"], transB=0)],
        inputs=[("x", np.float32, [None, 3, 32, 32])],
        outputs=[("y", np.float32, [None, classes])],
        initializers=[("w", rng.randn(32, 3, 3, 3).astype(np.float32)),
                      ("fcw", rng.randn(32, classes).astype(np.float32)),
                      ("fcb", np.zeros((classes,), np.float32))])


def test_onnx_paths(tmp_path, capsys):
    good = tmp_path / "m.onnx"
    good.write_bytes(_resnet_ish(256))
    assert main(["--onnx", str(good)]) == 0
    assert "clean" in capsys.readouterr().out
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(_onnx([P.encode_node("NonMaxSuppression", ["x"], ["y"])],
                          [("x", np.float32, [4])], [("y", np.float32, [4])]))
    assert main(["--onnx", str(bad)]) == 1
    assert "DL4J-E161" in capsys.readouterr().out


def test_onnx_resnet_from_the_fixtures(tmp_path, capsys):
    from deeplearning4j_tpu_torch.modelimport import onnx_fixtures as fx
    net = fx.SmallResNet50(num_classes=10, input_shape=(3, 32, 32)).init(
        device="cpu")
    path = fx.write_resnet50(net, str(tmp_path / "resnet.onnx"))
    assert main(["--onnx", path, "--warnings-ok"]) == 0
    out = capsys.readouterr().out
    assert "1 model(s) linted: 1 clean" in out


def test_samediff_flag(tmp_path, monkeypatch, capsys):
    (tmp_path / "torch_sdmodel.py").write_text(
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff\n"
        "sd = SameDiff.create(device='cpu')\n"
        "x = sd.placeHolder('x', shape=(None, 4))\n"
        "w = sd.var('w', np.ones((4, 2), np.float32))\n"
        "y = x.mmul(w)\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    assert main(["--samediff", "torch_sdmodel:sd"]) == 0
    assert "clean" in capsys.readouterr().out


# --------------------------------------------------------------- concurrency
def _fixture_sources():
    """The concurrency fixtures of tests/test_analysis.py, read from its
    source (the module-level ``_E2xx_*``/``_W21x_*``/``_MODULE_*``
    strings)."""
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str) \
                and node.targets[0].id.startswith(("_E2", "_W21",
                                                   "_MODULE_")):
            out[node.targets[0].id] = node.value.value
    return out


FIXTURES = _fixture_sources()


def test_the_fixture_set_is_whole():
    assert set(FIXTURES) == {
        "_E201_BAD", "_E201_CLEAN", "_E202_BAD", "_E203_BAD", "_W210_BAD",
        "_W211_BAD", "_W211_CLEAN", "_W212_BAD", "_W213_BAD", "_W213_CLEAN",
        "_MODULE_E201_BAD", "_MODULE_E201_CLEAN", "_MODULE_CLOSURE_EXEMPT",
        "_MODULE_QUEUE_EXEMPT"}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_concurrency_fixture_same_as_jax(name, tmp_path):
    path = tmp_path / "fixture.py"
    path.write_text(FIXTURES[name])
    j, t = j_concurrency(str(path)), t_concurrency(str(path))
    assert [(d.code, d.severity, d.location, d.message) for d in t] == \
        [(d.code, d.severity, d.location, d.message) for d in j]
    assert bool(j.codes()) == name.endswith("_BAD")


def test_concurrency_cli(tmp_path, capsys):
    p = tmp_path / "bad.py"
    p.write_text(FIXTURES["_E202_BAD"])
    assert main(["--concurrency", str(p)]) == 1
    assert "DL4J-E202" in capsys.readouterr().out
    assert main(["--concurrency", str(p), "--suppress", "E202"]) == 0
    with pytest.raises(SystemExit):
        main(["--concurrency", str(p), "LeNet"])
    for target in ("definitely_not_a_module_xyz", "sys"):
        with pytest.raises(SystemExit) as ei:
            main(["--concurrency", target])
        assert ei.value.code == 2
    capsys.readouterr()


def test_the_port_lints_itself_clean(capsys):
    report = t_concurrency("deeplearning4j_tpu_torch")
    assert report.codes() == [], report.format()
    assert main(["--concurrency"]) == 0             # defaults to the port
    assert "concurrency:deeplearning4j_tpu_torch: clean" in \
        capsys.readouterr().out


def test_zoo_run_without_a_card_allocates_no_parameter():
    code = (
        "import torch\n"
        "from deeplearning4j_tpu_torch.nn import layers as L\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a parameter was allocated')\n"
        "stack = [L.Layer]\n"
        "while stack:\n"
        "    cls = stack.pop()\n"
        "    stack.extend(cls.__subclasses__())\n"
        "    if 'initialize' in vars(cls):\n"
        "        cls.initialize = refuse\n"
        "L._initialize = refuse\n"
        "from deeplearning4j_tpu_torch.analysis.__main__ import main\n"
        "assert main(['--zoo']) == 0\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('NO-PARAMS-OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": "",
                               "PYTHONPATH": str(REPO)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "16 model(s) linted: 16 clean" in proc.stdout
    assert "NO-PARAMS-OK" in proc.stdout
