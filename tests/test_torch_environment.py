"""The port's runtime environment (``utils/environment.py``) against the
JAX package's: the same knobs and environment variables, parsed the same
way, every knob in ``describe()``; one ``NumericsPanicError`` class shared
by ``utils.environment``, ``train.resilience`` and ``profiler.sanitizer``;
``panic_check`` raising as the JAX one does."""

from dataclasses import fields

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import profiler as jprof
from deeplearning4j_tpu.utils import environment as jenv
from deeplearning4j_tpu_torch import profiler as tprof
from deeplearning4j_tpu_torch.profiler import sanitizer
from deeplearning4j_tpu_torch.train import resilience
from deeplearning4j_tpu_torch.utils import environment as tenv

#: (env var, raw value) per knob, parsed by both packages
OVERRIDES = {
    "debug": ("DL4J_TPU_DEBUG", "yes"),
    "verbose": ("DL4J_TPU_VERBOSE", "1"),
    "nan_panic": ("DL4J_TPU_NAN_PANIC", "ON"),
    "inf_panic": ("DL4J_TPU_INF_PANIC", "true"),
    "matmul_precision": ("DL4J_TPU_MATMUL_PRECISION", "tensorfloat32"),
    "profiling": ("DL4J_TPU_PROFILING", "no"),
    "profile_dir": ("DL4J_TPU_PROFILE_DIR", "/some/where"),
    "compile_cache_dir": ("DL4J_TPU_COMPILE_CACHE", "/cache"),
    "prefetch_buffer": ("DL4J_TPU_PREFETCH", "7"),
    "loader_threads": ("DL4J_TPU_LOADER_THREADS", "3"),
}


def _knobs(env_cls):
    return [f.name for f in fields(env_cls) if not f.name.startswith("_")]


def test_the_same_knobs_and_rows():
    assert _knobs(tenv.Environment) == _knobs(jenv.Environment)
    assert set(tenv.KNOBS) == set(jenv.KNOBS) == set(OVERRIDES)


def test_describe_covers_every_knob():
    desc = tenv.Environment().describe()
    for knob in tenv.KNOBS:
        assert knob in desc
        assert "DL4J_TPU_" + knob.upper() in desc
    assert len(desc.splitlines()) == len(tenv.KNOBS)


#: knobs that no code of the port reads
UNREAD = ("debug", "verbose", "matmul_precision", "compile_cache_dir",
          "prefetch_buffer", "loader_threads")


def test_tpu_only_knobs_say_they_steer_nothing():
    for knob in ("matmul_precision", "compile_cache_dir"):
        assert "steers nothing" in tenv.KNOBS[knob]


def test_unread_knobs_say_they_steer_nothing():
    for knob in tenv.KNOBS:
        assert ("steers nothing" in tenv.KNOBS[knob]) == (knob in UNREAD)


@pytest.mark.parametrize("knob", sorted(OVERRIDES))
def test_env_override_parses_as_in_jax(monkeypatch, knob):
    var, raw = OVERRIDES[knob]
    monkeypatch.setenv(var, raw)
    got = getattr(tenv.Environment(), knob)
    want = getattr(jenv.Environment(), knob)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("knob", sorted(set(OVERRIDES) - {"profile_dir"}))
def test_defaults_are_the_jax_ones(monkeypatch, knob):
    monkeypatch.delenv(OVERRIDES[knob][0], raising=False)
    assert getattr(tenv.Environment(), knob) == \
        getattr(jenv.Environment(), knob)


def test_profile_dir_defaults_under_the_temporary_directory(monkeypatch,
                                                            tmp_path):
    monkeypatch.delenv("DL4J_TPU_PROFILE_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert tenv.Environment().profile_dir == str(tmp_path
                                                 / "dl4j_tpu_profile")


def test_singleton_and_reset():
    tenv.Environment.reset()
    a = tenv.Environment.get()
    assert tenv.Environment.get() is a
    tenv.Environment.reset()
    assert tenv.Environment.get() is not a


def test_one_numerics_panic_error_class():
    cls = tenv.NumericsPanicError
    assert resilience.NumericsPanicError is cls
    assert sanitizer.NumericsPanicError is cls
    assert issubclass(sanitizer.NonfiniteAttributionError, cls)
    assert issubclass(cls, ArithmeticError)
    assert "NumericsPanicError" not in vars(resilience) or \
        vars(resilience)["NumericsPanicError"] is cls


def test_an_attribution_error_is_caught_as_a_panic():
    try:
        raise sanitizer.NonfiniteAttributionError("x")
    except resilience.NumericsPanicError as e:
        assert isinstance(e, tenv.NumericsPanicError)


@pytest.mark.parametrize("mode,value,word", [
    ("nan_panic", float("nan"), "NAN_PANIC"),
    ("inf_panic", float("inf"), "INF_PANIC")])
def test_panic_check_raises_as_in_jax(mode, value, word):
    jprof.set_profiling_mode(jprof.ProfilingMode(mode))
    tprof.set_profiling_mode(tprof.ProfilingMode(mode))
    try:
        with pytest.raises(jenv.NumericsPanicError) as je:
            jenv.panic_check(np.array([1.0, value]), context="loss")
        with pytest.raises(tenv.NumericsPanicError) as te:
            tenv.panic_check(torch.tensor([1.0, value]), context="loss")
        assert str(te.value) == str(je.value) and word in str(te.value)
        tenv.panic_check(torch.tensor([1, 2]))          # ints: nothing
        tenv.panic_check(torch.tensor([1.0, 2.0]))
    finally:
        jprof.set_profiling_mode(None)
        tprof.set_profiling_mode(None)


@pytest.mark.parametrize("knob,mode", [
    ("nan_panic", "NAN_PANIC"), ("inf_panic", "INF_PANIC"),
    ("profiling", "BASIC")])
def test_the_mode_follows_the_environment_as_in_jax(knob, mode):
    """``get_profiling_mode`` reads the one ``Environment``: setting a knob
    on the singleton changes the mode on both sides, ``reset()`` undoes
    it."""
    for env, prof in ((jenv, jprof), (tenv, tprof)):
        env.Environment.reset()
        prof.set_profiling_mode(None)
        try:
            assert prof.get_profiling_mode() is prof.ProfilingMode.OFF
            setattr(env.Environment.get(), knob, True)
            assert prof.get_profiling_mode() is prof.ProfilingMode[mode]
            prof.set_profiling_mode(prof.ProfilingMode.OFF)    # override wins
            assert prof.get_profiling_mode() is prof.ProfilingMode.OFF
            prof.set_profiling_mode(None)
            assert prof.get_profiling_mode() is prof.ProfilingMode[mode]
        finally:
            env.Environment.reset()
            prof.set_profiling_mode(None)
        assert prof.get_profiling_mode() is prof.ProfilingMode.OFF


def test_the_env_var_steers_the_mode_after_reset(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_NAN_PANIC", "1")
    try:
        for env, prof in ((jenv, jprof), (tenv, tprof)):
            env.Environment.reset()
            prof.set_profiling_mode(None)
            assert prof.get_profiling_mode() is prof.ProfilingMode.NAN_PANIC
    finally:
        monkeypatch.delenv("DL4J_TPU_NAN_PANIC")
        jenv.Environment.reset()
        tenv.Environment.reset()


def test_profile_dir_is_the_listeners_default(tmp_path):
    from deeplearning4j_tpu_torch.train import listeners
    tenv.Environment.reset()
    try:
        tenv.Environment.get().profile_dir = str(tmp_path)
        assert listeners.default_profile_dir() == str(tmp_path)
        assert listeners.ProfilingListener().log_dir == str(tmp_path)
    finally:
        tenv.Environment.reset()


def test_one_parser_of_the_knobs():
    """No module of the port reads a ``DL4J_TPU_*`` knob of the
    environment beside ``utils/environment.py``."""
    import pathlib
    import deeplearning4j_tpu_torch
    root = pathlib.Path(deeplearning4j_tpu_torch.__file__).parent
    names = {var for var, _ in OVERRIDES.values()}
    for path in root.rglob("*.py"):
        if path.name == "environment.py" and path.parent.name == "utils":
            continue
        text = path.read_text()
        for var in names:
            assert f'"{var}"' not in text, (path, var)


def test_panic_check_is_silent_when_off():
    tprof.set_profiling_mode(None)
    assert tprof.get_profiling_mode() is tprof.ProfilingMode.OFF
    tenv.panic_check(torch.tensor([float("nan")]))
