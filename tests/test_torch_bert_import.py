"""The port's BERT checkpoint import (``modelimport/bert.py``) and the
frozen-BERT GraphDef writer (``modelimport/tf_fixtures.py``) against
HuggingFace, TensorFlow and the JAX package (CPU).

A small ``transformers.BertModel`` (2 layers, E=32, 4 heads, as
``tests/test_modelimport.py`` builds it) is saved as ``.bin``, as
``.safetensors`` and under google-research TF names; the port's
``encode`` of each import is held against HF's ``last_hidden_state`` and
against JAX ``importBertModelAndWeights`` + ``encode`` at ``rtol=1e-4,
atol=1e-5``, and the port's params equal ``params_from_jax`` of the JAX
import bit for bit. 8 Adam steps of ``make_train_step`` against the JAX
step. The GraphDef writer at small width (2 layers, E=32): the port's
import of its bytes against TF running the same bytes, against path A's
``encode`` on the same weights (both 1e-5), and against HF
``BertForSequenceClassification`` loaded from :func:`hf_state`.
"""


import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.modelimport import bert as jbert  # noqa: E402
from deeplearning4j_tpu.models import transformer as jtfm  # noqa: E402
from deeplearning4j_tpu.train import updaters as jupd  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig  # noqa: E402,E501
from deeplearning4j_tpu_torch.modelimport import bert as tbert  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import tf_fixtures as fx  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    importTensorflowGraph)
from deeplearning4j_tpu_torch.models import transformer as ttfm  # noqa: E402
from deeplearning4j_tpu_torch.train import updaters as tupd  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(V=99, E=32, L=2, F=64, P=40, TV=2, n_labels=2)
T = 10


@pytest.fixture(scope="module")
def hf_bert():
    cfg = transformers.BertConfig(
        vocab_size=99, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    model = transformers.BertModel(cfg).eval()
    ids = np.random.RandomState(0).randint(0, 99, (2, T)).astype(np.int64)
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).last_hidden_state.numpy()
    return model, ids, want


def _tf_named(model):
    """The HF state under google-research names (the JAX test's map)."""
    out = {}
    for k, v in model.state_dict().items():
        arr = v.detach().numpy()
        tk = ("bert/" + k.replace("encoder.layer.", "encoder/layer_")
              ).replace(".", "/")
        if tk.endswith("/weight"):
            if "_embeddings" in tk:
                tk = tk[:-len("/weight")]
            elif arr.ndim == 2:
                tk, arr = tk[:-len("/weight")] + "/kernel", arr.T
            elif "LayerNorm" in tk:
                tk = tk[:-len("/weight")] + "/gamma"
        if tk.endswith("/bias") and "LayerNorm" in tk:
            tk = tk[:-len("/bias")] + "/beta"
        out[tk] = torch.from_numpy(arr.copy())
    return out


def _save(model, tmp_path, kind):
    if kind == "bin":
        p = str(tmp_path / "bert.bin")
        torch.save(model.state_dict(), p)
    elif kind == "safetensors":
        st = pytest.importorskip("safetensors.torch")
        p = str(tmp_path / "bert.safetensors")
        st.save_file(model.state_dict(), p)
    else:
        p = str(tmp_path / "bert_tf.bin")
        torch.save(_tf_named(model), p)
    return p


@pytest.mark.parametrize("kind", ["bin", "safetensors", "tf_names"])
def test_encode_matches_hf_and_jax(hf_bert, tmp_path, kind):
    model, ids, want = hf_bert
    p = _save(model, tmp_path, kind)
    cfg, params = tbert.importBertModelAndWeights(p, device="cpu", n_heads=4)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.n_heads,
            cfg.d_ff, cfg.max_len, cfg.type_vocab_size) == \
        (2, 32, 99, 4, 64, 40, 2)
    assert cfg.arch == "postln_bert" and cfg.dtype == torch.float32 \
        and cfg.layer_norm_eps == 1e-12
    got = ttfm.encode(params, torch.from_numpy(ids), cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jcfg, jparams = jbert.importBertModelAndWeights(p, n_heads=4)
    np.testing.assert_allclose(
        got, np.asarray(jtfm.encode(jparams, ids.astype(np.int32), jcfg)),
        **TOL)


@pytest.mark.parametrize("kind", ["bin", "safetensors", "tf_names"])
def test_params_equal_params_from_jax_bit_for_bit(hf_bert, tmp_path, kind):
    model, _, _ = hf_bert
    p = _save(model, tmp_path, kind)
    cfg, params = tbert.importBertModelAndWeights(p, device="cpu", n_heads=4)
    jcfg, jparams = jbert.importBertModelAndWeights(p, n_heads=4)
    want = ttfm.params_from_jax(jparams, cfg, device="cpu")
    got_leaves, want_leaves = ttfm._leaf_paths(params), \
        ttfm._leaf_paths(want)
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_attention_mask_matches_hf(hf_bert, tmp_path):
    model, ids, _ = hf_bert
    mask = np.ones((2, T), np.float32)
    mask[:, 7:] = 0.0
    with torch.no_grad():
        want = model(torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask)
                     ).last_hidden_state.numpy()
    cfg, params = tbert.importBertModelAndWeights(
        _save(model, tmp_path, "bin"), device="cpu", n_heads=4)
    got = ttfm.encode(params, torch.from_numpy(ids), cfg,
                      attn_mask=torch.from_numpy(mask)).numpy()
    # masked-out positions attend garbage in both: compare the valid ones
    np.testing.assert_allclose(got[:, :7], want[:, :7], **TOL)


def test_safetensors_reader_equals_the_package(tmp_path):
    st_np = pytest.importorskip("safetensors.numpy")
    st_t = pytest.importorskip("safetensors.torch")
    rng = np.random.RandomState(3)
    arrays = {"f32": rng.randn(3, 4).astype(np.float32),
              "f16": rng.randn(5).astype(np.float16),
              "f64": rng.randn(2, 2),
              "i64": rng.randint(-9, 9, (4,)).astype(np.int64),
              "i32": rng.randint(-9, 9, (2, 3)).astype(np.int32),
              "u8": rng.randint(0, 255, (6,)).astype(np.uint8),
              "b": rng.rand(3) > 0.5,
              "scalar": np.array(2.5, np.float32)}
    p = str(tmp_path / "a.safetensors")
    st_np.save_file(arrays, p, metadata={"format": "np"})
    got, want = tbert.load_safetensors(p), st_np.load_file(p)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    bf = torch.randn(3, 5, dtype=torch.float32).to(torch.bfloat16)
    pb = str(tmp_path / "bf.safetensors")
    st_t.save_file({"w": bf}, pb)
    np.testing.assert_array_equal(tbert.load_safetensors(pb)["w"],
                                  st_t.load_file(pb)["w"].float().numpy())


def test_train_steps_match_jax(hf_bert, tmp_path):
    model, ids, _ = hf_bert
    p = _save(model, tmp_path, "bin")
    cfg, params = tbert.importBertModelAndWeights(p, device="cpu", n_heads=4)
    jcfg, jparams = jbert.importBertModelAndWeights(p, n_heads=4)
    tgt = np.roll(ids, 1, axis=1)
    mask = np.ones(ids.shape, np.float32)

    updater = tupd.Adam(1e-3)
    opt = ttfm.init_opt_state(params, updater)
    step = ttfm.make_train_step(cfg, updater)
    t_dev = torch.zeros((), dtype=torch.int32)
    got = [float(step(params, opt, t_dev, torch.from_numpy(ids),
                      torch.from_numpy(tgt), torch.from_numpy(mask)))
           for _ in range(8)]

    jupdater = jupd.Adam(1e-3)
    jopt = jtfm.init_opt_state(jparams, jupdater)
    jstep = jtfm.make_train_step(jcfg, jupdater, mesh=None)
    jt = jnp.asarray(0, jnp.int32)
    want = []
    for _ in range(8):
        jparams, jopt, jt, loss = jstep(
            jparams, jopt, jt, jnp.asarray(ids, jnp.int32),
            jnp.asarray(tgt, jnp.int32), jnp.asarray(mask))
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    assert got[-1] < got[0] and int(t_dev) == 8
    # the unused final_norm leaves stay put (zero gradient, as jax.grad)
    assert torch.equal(params["final_norm"]["g"], torch.ones(32))


def test_import_errors(tmp_path):
    p = str(tmp_path / "empty.bin")
    torch.save({"bert.embeddings.word_embeddings.weight": torch.zeros(9, 4),
                "bert.embeddings.position_embeddings.weight":
                    torch.zeros(8, 4)}, p)
    with pytest.raises(tbert.BertImportError, match="encoder.layer"):
        tbert.importBertModelAndWeights(p, device="cpu")
    # an HF ([out, in]) checkpoint carrying a TF-style key is read as TF
    # once for all its keys, and the intermediate bias then disagrees
    w = fx.bert_weights(0, **SMALL)
    state = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in fx.hf_state(w).items()}
    state["bert/extra/kernel"] = torch.zeros(1)
    p2 = str(tmp_path / "mixed.bin")
    torch.save(state, p2)
    with pytest.raises(tbert.BertImportError, match="bias length"):
        tbert.importBertModelAndWeights(p2, device="cpu", n_heads=4)
    p3 = str(tmp_path / "x.safetensors")
    with open(p3, "wb") as f:
        f.write(b"\x01")
    with pytest.raises(tbert.BertImportError, match="safetensors"):
        tbert.importBertModelAndWeights(p3, device="cpu")


def test_import_raises_without_a_card_unless_given_the_cpu(hf_bert, tmp_path,
                                                           monkeypatch):
    p = _save(hf_bert[0], tmp_path, "bin")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.importBertModelAndWeights(p, n_heads=4)


# ---------------------------------------------------- the GraphDef writer

@pytest.fixture(scope="module")
def small_graph():
    w = fx.bert_weights(0, **SMALL)
    gd = fx.bert_graph_def(w, T=T, H=4)
    ids = np.random.default_rng(1).integers(0, 99, (3, T)).astype(np.int32)
    return w, gd, ids


def _path_a(w, ids, tmp_path, fmt):
    """Path A on the same weights: the checkpoint import, encode, then
    the pooler and classifier applied to the [CLS] row."""
    state = w if fmt == "tf" else fx.hf_state(w)
    p = str(tmp_path / f"{fmt}.bin")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in state.items()}, p)
    cfg, params = tbert.importBertModelAndWeights(p, device="cpu", n_heads=4)
    x = ttfm.encode(params, torch.from_numpy(ids).long(), cfg)
    pooled = torch.tanh(x[:, 0] @ torch.from_numpy(
        w["bert/pooler/dense/kernel"]) + torch.from_numpy(
        w["bert/pooler/dense/bias"]))
    logits = pooled @ torch.from_numpy(w["output_weights"]).T \
        + torch.from_numpy(w["output_bias"])
    return params, pooled, logits


def test_written_graph_imports_as_tensorflow_runs_it(small_graph):
    tf = pytest.importorskip("tensorflow")
    from tensorflow.core.framework import graph_pb2
    _, gd, ids = small_graph
    sd = importTensorflowGraph(gd, device="cpu")
    got = sd.output({"input_ids": ids}, ["pooled_output", "logits"])
    g = graph_pb2.GraphDef()
    g.ParseFromString(gd)
    with tf.Graph().as_default() as graph:
        tf.compat.v1.import_graph_def(g, name="")
        with tf.compat.v1.Session(graph=graph) as s:
            pooled, logits = s.run(["pooled_output:0", "logits:0"],
                                   {"input_ids:0": ids})
    np.testing.assert_allclose(got["pooled_output"].numpy(), pooled,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["logits"].numpy(), logits, rtol=0,
                               atol=1e-5)
    ops = {n.op for n in g.node}
    assert {"GatherV2", "OneHot", "MatMul", "BiasAdd", "Reshape",
            "Transpose", "BatchMatMulV2", "Mul", "AddV2", "Sub", "Softmax",
            "Mean", "SquaredDifference", "Rsqrt", "Erf", "Tanh",
            "StridedSlice", "Squeeze"} <= ops
    assert sd.import_report.codes() == []


@pytest.mark.parametrize("fmt", ["hf", "tf"])
def test_written_graph_equals_path_a(small_graph, tmp_path, fmt):
    w, gd, ids = small_graph
    _, pooled, logits = _path_a(w, ids, tmp_path, fmt)
    got = importTensorflowGraph(gd, device="cpu").output(
        {"input_ids": ids}, ["pooled_output", "logits"])
    np.testing.assert_allclose(got["pooled_output"].numpy(),
                               pooled.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(),
                               rtol=0, atol=1e-5)


def test_hf_state_loads_into_transformers_and_agrees(small_graph):
    w, gd, ids = small_graph
    cfg = transformers.BertConfig(
        vocab_size=99, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=2, num_labels=2,
        layer_norm_eps=1e-12, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    model = transformers.BertForSequenceClassification(cfg).eval()
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in fx.hf_state(w).items()}, strict=False)
    assert not unexpected and all("position_ids" in k for k in missing)
    with torch.no_grad():
        want = model(torch.from_numpy(ids).long()).logits.numpy()
    got = importTensorflowGraph(gd, device="cpu").output(
        {"input_ids": ids}, ["logits"])["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_written_graph_fine_tunes_and_round_trips(small_graph, tmp_path):
    """Phase 24's path at small width: unfreeze the weights the graph
    consumes, attach a softmax cross-entropy on a labels placeholder, fit
    with DL4J's Adam; save/load gives the same logits to the bit."""
    w, gd, ids = small_graph
    sd = importTensorflowGraph(gd, device="cpu")
    consumed = {i for node in sd._nodes for i in node.inputs}
    trained = [n for n in w if n in consumed]
    assert len(trained) == len(w) - 1     # the position table folds
    sd.convertToVariables(*trained)
    labels = sd.placeHolder("labels", shape=(None, 2), dtype=np.float32)
    sd.loss.softmaxCrossEntropy(labels, sd.getVariable("logits"),
                                name="loss")
    sd.setLossVariables("loss")
    sd.setTrainingConfig(TrainingConfig(
        updater=tupd.Adam(1e-3), data_set_feature_mapping=["input_ids"],
        data_set_label_mapping=["labels"]))
    y = np.eye(2, dtype=np.float32)[[0, 1, 1]]
    losses = sd.fit({"input_ids": ids, "labels": y}, epochs=6).lossCurve()
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    p = str(tmp_path / "bert_tf.sdz")
    sd.save(p)
    want = sd.output({"input_ids": ids}, ["logits"])["logits"]
    got = SameDiff.load(p, device="cpu").output({"input_ids": ids},
                                                ["logits"])["logits"]
    assert torch.equal(got, want)


def test_written_graph_gradients_match_tensorflow(small_graph):
    """The fine-tune's gradients through the imported graph (every
    consumed weight, the mean softmax cross-entropy over the batch)
    against ``tf.gradients`` on the same bytes."""
    tf = pytest.importorskip("tensorflow")
    from tensorflow.core.framework import graph_pb2
    w, gd, ids = small_graph
    y = np.eye(2, dtype=np.float32)[[0, 1, 1]]
    sd = importTensorflowGraph(gd, device="cpu")
    consumed = {i for node in sd._nodes for i in node.inputs}
    trained = [n for n in w if n in consumed]
    sd.convertToVariables(*trained)
    labels = sd.placeHolder("labels", shape=(None, 2), dtype=np.float32)
    sd.loss.softmaxCrossEntropy(labels, sd.getVariable("logits"),
                                name="loss")
    sd.setLossVariables("loss")
    got = sd.calculateGradients({"input_ids": ids, "labels": y}, trained)
    g = graph_pb2.GraphDef()
    g.ParseFromString(gd)
    with tf.Graph().as_default() as graph:
        tf.compat.v1.import_graph_def(g, name="")
        lab = tf.compat.v1.placeholder(tf.float32, (None, 2))
        loss = tf.reduce_mean(tf.nn.softmax_cross_entropy_with_logits(
            labels=lab, logits=graph.get_tensor_by_name("logits:0")))
        grads = [tf.convert_to_tensor(gr) for gr in tf.gradients(
            loss, [graph.get_tensor_by_name(n + ":0") for n in trained])]
        with tf.compat.v1.Session(graph=graph) as s:
            want = s.run(grads, {"input_ids:0": ids, lab: y})
    # every element within 1e-4 of the largest gradient: some (the key
    # biases') are zero in exact arithmetic and pure rounding in both
    scale = max(float(np.abs(wv).max()) for wv in want)
    for n, wv in zip(trained, want):
        np.testing.assert_allclose(got[n].numpy(), wv, rtol=0,
                                   atol=1e-4 * scale, err_msg=n)
