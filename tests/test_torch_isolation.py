"""The port stands alone: ``deeplearning4j_tpu_torch`` and
``chip_smoke.py`` import nothing of JAX or of the JAX package, and the
port's entry points run on the card unless told otherwise."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deeplearning4j_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "deeplearning4j_tpu"}
#: what the card's machine lacks, so the port parses and loads model files
#: itself: TF and protobuf (GraphDefs), ml_dtypes (bf16), safetensors and
#: transformers (checkpoints), h5py and Keras (Keras .h5 saves); matched
#: by dotted prefix
FORBIDDEN_LIBS = ("tensorflow", "google.protobuf", "ml_dtypes",
                  "safetensors", "transformers", "h5py", "keras", "onnx",
                  "onnxruntime")
#: the interop runners run a foreign graph with its own engine (the
#: reference's GraphRunner and OnnxRuntimeRunner): each imports its engine
#: inside its constructor, never at module level
ENGINE_IMPORTS = {"deeplearning4j_tpu_torch/modelimport/interop.py":
                  ("tensorflow", "onnxruntime")}


def _imported_names(path: Path):
    """The full dotted name of every import in a file, lazy ones
    (inside functions, ``__import__``, ``importlib.import_module``)
    included."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
                for a in node.names:
                    yield f"{node.module}.{a.name}"
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _imported_roots(path: Path):
    """First dotted component of every import in a file (by component,
    not prefix: 'deeplearning4j_tpu_torch' is not 'deeplearning4j_tpu')."""
    for name in _imported_names(path):
        yield name.split(".")[0]


def _forbidden_lib(name: str) -> bool:
    return any(name == lib or name.startswith(lib + ".")
               for lib in FORBIDDEN_LIBS)


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _engine_import(path: Path, name: str) -> bool:
    allowed = ENGINE_IMPORTS.get(str(path.relative_to(ROOT)), ())
    return any(name == lib or name.startswith(lib + ".") for lib in allowed)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_tf_protobuf_or_checkpoint_library_imports(path):
    bad = sorted({n for n in _imported_names(path) if _forbidden_lib(n)
                  and not _engine_import(path, n)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", sorted(ENGINE_IMPORTS))
def test_engine_imports_stay_inside_the_runners(rel):
    """An interop runner's engine is imported in a function body only, so
    the module imports where the engine is missing."""
    tree = ast.parse((ROOT / rel).read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    names = {a.name for n in top if isinstance(n, ast.Import)
             for a in n.names} | {n.module for n in top
                                  if isinstance(n, ast.ImportFrom)}
    assert not {n for n in names if n and _forbidden_lib(n)}
    lazy = {n for n in _imported_names(ROOT / rel) if _forbidden_lib(n)}
    assert lazy and all(_engine_import(ROOT / rel, n) for n in lazy)


def test_the_library_check_sees_lazy_and_from_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from google import protobuf\n"
                   "    import importlib\n"
                   "    importlib.import_module('safetensors.numpy')\n"
                   "from google.protobuf import message\n")
    names = {n for n in _imported_names(src) if _forbidden_lib(n)}
    assert names == {"google.protobuf", "safetensors.numpy",
                     "google.protobuf.message"}
    assert not _forbidden_lib("google") and not _forbidden_lib("tensorflowx")


def test_component_check_is_not_a_prefix_check():
    assert "deeplearning4j_tpu_torch".split(".")[0] not in FORBIDDEN


def _run(code, cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_jax_unloaded():
    r = _run("import sys, deeplearning4j_tpu_torch.serving, "
             "deeplearning4j_tpu_torch.models.transformer, "
             "deeplearning4j_tpu_torch.autodiff, "
             "deeplearning4j_tpu_torch.profile_samediff, "
             "deeplearning4j_tpu_torch.ops.cuda_kernels, "
             "deeplearning4j_tpu_torch.nn.multilayer, "
             "deeplearning4j_tpu_torch.nn.objdetect, "
             "deeplearning4j_tpu_torch.models.zoo, "
             "deeplearning4j_tpu_torch.benchmarks.probe_bn_leaky, "
             "deeplearning4j_tpu_torch.analysis, "
             "deeplearning4j_tpu_torch.nn.compilecache, "
             "deeplearning4j_tpu_torch.train.stepping, "
             "deeplearning4j_tpu_torch.profile_fit, "
             "deeplearning4j_tpu_torch.profiler.tracer, "
             "deeplearning4j_tpu_torch.profiler.tracecontext, "
             "deeplearning4j_tpu_torch.profiler.flightrec, "
             "deeplearning4j_tpu_torch.profiler.modes, "
             "deeplearning4j_tpu_torch.profiler.locks, "
             "deeplearning4j_tpu_torch.profiler.sanitizer, "
             "deeplearning4j_tpu_torch.profiler.devicetime, "
             "deeplearning4j_tpu_torch.profiler.aggregate, "
             "deeplearning4j_tpu_torch.profiler.slo, "
             "deeplearning4j_tpu_torch.ui, "
             "deeplearning4j_tpu_torch.ui.stats, "
             "deeplearning4j_tpu_torch.ui.server, "
             "deeplearning4j_tpu_torch.train.listeners, "
             "deeplearning4j_tpu_torch.parallel.elastic, "
             "deeplearning4j_tpu_torch.train.resilience, "
             "deeplearning4j_tpu_torch.faults, "
             "deeplearning4j_tpu_torch.analysis.serving, "
             "deeplearning4j_tpu_torch.serving.server, "
             "deeplearning4j_tpu_torch.serving.registry, "
             "deeplearning4j_tpu_torch.serving.ingress, "
             "deeplearning4j_tpu_torch.nn.preprocessors, "
             "deeplearning4j_tpu_torch.evaluation, "
             "deeplearning4j_tpu_torch.train.serializer, "
             "deeplearning4j_tpu_torch.data.iterators, "
             "deeplearning4j_tpu_torch.data.dataset, "
             "deeplearning4j_tpu_torch.data.records, "
             "deeplearning4j_tpu_torch.data.audio, "
             "deeplearning4j_tpu_torch.data.datavec_fixtures, "
             "deeplearning4j_tpu_torch.ops.normalization, "
             "deeplearning4j_tpu_torch.ops.convolution, "
             "deeplearning4j_tpu_torch.ops.losses, "
             "deeplearning4j_tpu_torch.ops.registry, "
             "deeplearning4j_tpu_torch.data.image, "
             "deeplearning4j_tpu_torch.data.decode, "
             "deeplearning4j_tpu_torch.data.pipeline, "
             "deeplearning4j_tpu_torch.utils.concurrent, "
             "deeplearning4j_tpu_torch.modelimport.bert, "
             "deeplearning4j_tpu_torch.modelimport._wire, "
             "deeplearning4j_tpu_torch.modelimport.tf_proto, "
             "deeplearning4j_tpu_torch.modelimport.tensorflow, "
             "deeplearning4j_tpu_torch.modelimport.tf_fixtures, "
             "deeplearning4j_tpu_torch.modelimport.hdf5, "
             "deeplearning4j_tpu_torch.modelimport.keras, "
             "deeplearning4j_tpu_torch.modelimport.keras_fixtures, "
             "deeplearning4j_tpu_torch.modelimport.onnx_proto, "
             "deeplearning4j_tpu_torch.modelimport.onnx, "
             "deeplearning4j_tpu_torch.modelimport.onnx_fixtures, "
             "deeplearning4j_tpu_torch.modelimport.interop, "
             "deeplearning4j_tpu_torch.nn.transfer, "
             "deeplearning4j_tpu_torch.nn.layers, "
             "deeplearning4j_tpu_torch.analysis.imports, "
             "deeplearning4j_tpu_torch.linalg, "
             "deeplearning4j_tpu_torch.ops.registry_ext, "
             "deeplearning4j_tpu_torch.ops.registry_r5, "
             "deeplearning4j_tpu_torch.ops.shapes, "
             "deeplearning4j_tpu_torch.ops.validation, "
             "deeplearning4j_tpu_torch.ops.validation_ext, "
             "deeplearning4j_tpu_torch.ops.validation_r5, "
             "deeplearning4j_tpu_torch.utils.environment; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'deeplearning4j_tpu', 'tensorflow', "
             "'ml_dtypes', 'safetensors', 'transformers', 'h5py', "
             "'keras', 'onnx', 'onnxruntime') "
             "or m.startswith('google.protobuf')))", ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_transformer_lm_raises_without_a_card(monkeypatch):
    from deeplearning4j_tpu_torch.models import transformer as ttr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttr.TransformerConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.TransformerLM(cfg)
    assert ttr.TransformerLM(cfg, device="cpu").n_params() > 0


@pytest.mark.parametrize("entry", ["ModelServer", "ModelRegistry",
                                   "HttpIngress"])
def test_serving_entry_points_raise_without_a_card(monkeypatch, entry):
    from deeplearning4j_tpu_torch import serving
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {"ModelServer": lambda: serving.ModelServer(lambda x: x),
            "ModelRegistry": lambda: serving.ModelRegistry(),
            "HttpIngress": lambda: serving.HttpIngress(
                serving.ModelRegistry(), port=0)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: the script would run")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


_MODULE_NAME = re.compile(r"^[A-Za-z_]\w*(\.\w+)*(:\w+)?$")


def _module_name_strings(path: Path):
    """String constants shaped like a module name (``pkg.mod`` or
    ``pkg.mod:attr``): what a CLI hands ``importlib`` or
    ``importlib.util.find_spec`` later, such as the analyzer's
    ``--concurrency`` default."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _MODULE_NAME.match(node.value):
            yield node.value


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_name_strings_of_the_jax_package(path):
    """The import check reads import statements; a module named in a
    string and resolved at run time (a CLI's default target) is checked
    here."""
    bad = sorted({s for s in _module_name_strings(path)
                  if re.split(r"[.:]", s)[0] in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_the_analyzer_cli_targets_the_port():
    cli = PORT / "analysis" / "__main__.py"
    names = set(_module_name_strings(cli))
    assert "deeplearning4j_tpu_torch" in names         # --concurrency
    assert "deeplearning4j_tpu_torch.models" in set(_imported_names(cli))


#: the op surface's math: every op runs on the device of its inputs
OP_MATH = ["ops/registry.py", "ops/registry_ext.py", "ops/registry_r5.py",
           "ops/shapes.py", "linalg/ndarray.py", "linalg/factory.py",
           "linalg/transforms.py", "linalg/conditions.py"]


@pytest.mark.parametrize("rel", OP_MATH)
def test_op_math_has_no_host_escape(rel):
    """No scipy, and no ``.cpu()``/``.numpy()`` round trip, in the
    registry's and the eager arrays' math (``NDArray.numpy`` and the
    ``to*Vector`` conversions are the host boundary, named so)."""
    path = PORT / rel
    assert not {n for n in _imported_names(path)
                if n == "scipy" or n.startswith("scipy.")}
    tree = ast.parse(path.read_text())
    boundary = {"numpy", "toDoubleMatrix", "toFloatMatrix",
                "toDoubleVector", "toFloatVector", "toIntVector",
                "toIntMatrix", "toLongVector", "toLongMatrix",
                "toByteVector", "data", "__array__", "__repr__"}
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name in boundary:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr in (
                    "cpu", "numpy"):
                raise AssertionError(f"{rel}:{node.lineno} {fn.name} calls "
                                     f".{node.func.attr}()")


def test_the_nd_factory_raises_without_a_card(monkeypatch):
    from deeplearning4j_tpu_torch.linalg import NDArray, nd
    from deeplearning4j_tpu_torch.ops import validation
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **k: nd.zeros(3, **k), lambda **k: nd.ones(2, **k),
                 lambda **k: nd.create([1.0], **k),
                 lambda **k: nd.arange(3, **k), lambda **k: nd.eye(2, **k),
                 lambda **k: nd.rand(2, **k), lambda **k: nd.randn(2, **k),
                 lambda **k: NDArray([1.0], **k)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").device.type == "cpu"
    case = validation.all_cases()[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validation.run_case(case)
    validation.run_case(case, device="cpu")


def test_creation_ops_run_on_cuda_unless_told(monkeypatch):
    from deeplearning4j_tpu_torch.ops import registry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for op, args in (("eye", (3,)), ("fill", ((2,), 1.0)),
                     ("linspace", (0.0, 1.0, 3)), ("range", (4,)),
                     ("zeros", ((2,),)), ("ones", ((2,),)),
                     ("empty", ((2,),))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.get(op)(*args)
        assert registry.get(op)(*args, device="cpu").device.type == "cpu"
