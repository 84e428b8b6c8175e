"""The port stands alone: ``deeplearning4j_tpu_torch`` and
``chip_smoke.py`` import nothing of JAX or of the JAX package, and the
port's entry points run on the card unless told otherwise."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deeplearning4j_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "deeplearning4j_tpu"}


def _imported_roots(path: Path):
    """First dotted component of every import in a file (by component,
    not prefix: 'deeplearning4j_tpu_torch' is not 'deeplearning4j_tpu')."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


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
             "deeplearning4j_tpu_torch.ops.cuda_kernels; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'deeplearning4j_tpu')))", ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_transformer_lm_raises_without_a_card(monkeypatch):
    from deeplearning4j_tpu_torch.models import transformer as ttr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttr.TransformerConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.TransformerLM(cfg)
    assert ttr.TransformerLM(cfg, device="cpu").n_params() > 0


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
