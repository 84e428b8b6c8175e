"""The port's NLP (``deeplearning4j_tpu_torch.nlp``) against the JAX
package's (``tests/test_nlp.py``), on the CPU.

- Tokenizers, ``VocabCache`` and ``_pairs_from_ids``: exactly (both are
  host code over the same numpy draws).
- One skip-gram, one CBOW and one ParagraphVectors step from the same
  tables, with the JAX negatives (``jax.random.categorical`` on the JAX
  step's own key) injected into the port's step through
  ``word2vec.draw_negatives``: tables within 2e-6 after the update (fp32;
  the scatter-adds sum repeated rows in another order).
- The port's own negatives (the counter hash through the inverse CDF)
  against the unigram^0.75 table by a chi-square bound.
- The serializer both ways across packages, byte for byte.
- The JAX test's cluster and nearest-word checks at its own config.
- The mesh: the twins of ``tests/test_nlp.py``'s mesh tests (sharded
  tables and sharded training, :99-140) run on 2 spawned gloo ranks on
  the CPU (the JAX tests' ``data=2 x model=4`` and ``model=8`` meshes
  become ``model=2``), at the JAX tests' tolerances: the tables split
  over ``model`` train to the replicated tables within ``rtol=2e-4,
  atol=1e-5``, their similarities within ``rtol=1e-3``. The ranks import
  this module, JAX with it, and call none of it.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nlp import (CommonPreprocessor as JCommon,
                                    DefaultTokenizerFactory as JDefault,
                                    NGramTokenizerFactory as JNGram,
                                    ParagraphVectors as JPV,
                                    Word2Vec as JW2V,
                                    WordVectorSerializer as JSer)
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu_torch.nlp import (CommonPreprocessor,
                                          DefaultTokenizerFactory,
                                          LowCasePreProcessor,
                                          NGramTokenizerFactory,
                                          ParagraphVectors, SequenceVectors,
                                          VocabCache, Word2Vec,
                                          WordVectorSerializer)
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v

TOL = 2e-6


def _corpus(n_sent=300, seed=0):
    """The JAX test's corpus: two topics with disjoint vocabularies."""
    rng = np.random.RandomState(seed)
    animals = ["cat", "dog", "horse", "sheep", "cow"]
    tech = ["cpu", "gpu", "tpu", "ram", "disk"]
    sents = []
    for _ in range(n_sent):
        pool = animals if rng.rand() < 0.5 else tech
        sents.append(" ".join(rng.choice(pool, 6)))
    return sents, animals, tech


SENTENCES = ["The QUICK, brown fox (2024)!", "a b c d", "Hello   world",
             "it's 3:45 -- [ok] / done?", "", "MiXeD CaSe; words|here"]


@pytest.mark.parametrize("sentence", SENTENCES)
def test_tokenizers_equal_the_jax_ones(sentence):
    for pre_t, pre_j in ((None, None), (CommonPreprocessor(), JCommon()),
                         (LowCasePreProcessor(), None)):
        tf, jf = DefaultTokenizerFactory(), JDefault()
        if pre_t is not None:
            tf.setTokenPreProcessor(pre_t)
            from deeplearning4j_tpu.nlp.tokenization import \
                LowCasePreProcessor as JLow
            jf.setTokenPreProcessor(pre_j if pre_j is not None else JLow())
        assert tf.create(sentence).getTokens() == \
            jf.create(sentence).getTokens()
        tok, jtok = tf.create(sentence), jf.create(sentence)
        assert tok.countTokens() == jtok.countTokens()
    for n in (1, 2, 3):
        assert NGramTokenizerFactory(n).create(sentence).getTokens() == \
            JNGram(n).create(sentence).getTokens()


def test_vocab_and_pairs_equal_the_jax_ones():
    sents, _, _ = _corpus(80, seed=4)
    toks = [s.split() for s in sents] + [["rare"], ["cat", "rare"]]
    for minf in (1, 2, 3):
        v, jv = VocabCache.build(toks, minf), jw2v.VocabCache.build(toks,
                                                                    minf)
        assert v.idx2word == jv.idx2word and v.counts == jv.counts
        assert v.word2idx == jv.word2idx
        assert v.indexOf("nope") == jv.indexOf("nope") == -1
    ids = np.arange(17, dtype=np.int32) % 7
    for window in (1, 3, 5):
        a = tw2v._pairs_from_ids(ids, window, np.random.RandomState(window))
        b = jw2v._pairs_from_ids(ids, window, np.random.RandomState(window))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _tables(V=40, D=16, seed=0):
    rng = np.random.RandomState(seed)
    syn0 = ((rng.rand(V, D) - 0.5) / D).astype(np.float32)
    syn1 = (rng.randn(V, D) * 0.1).astype(np.float32)
    counts = sorted(rng.randint(1, 200, V).tolist(), reverse=True)
    return syn0, syn1, counts


def _neg_logits(counts):
    freq = np.asarray(counts, np.float64) ** 0.75
    return jnp.asarray(np.log(freq / freq.sum()), jnp.float32)


def _inject(monkeypatch, negs):
    def draw(key, cdf, shape):
        assert tuple(shape) == negs.shape
        return torch.from_numpy(np.asarray(negs, np.int64))
    monkeypatch.setattr(tw2v, "draw_negatives", draw)


@pytest.mark.parametrize("algo", ["skipgram", "cbow"])
def test_one_step_equals_the_jax_step(algo, monkeypatch):
    V, D, B, K = 40, 16, 64, 5
    syn0, syn1, counts = _tables(V, D)
    rng = np.random.RandomState(1)
    # repeated words: the scatter-adds must sum them
    centers = rng.randint(0, 12, B).astype(np.int32)
    contexts = rng.randint(0, V, B).astype(np.int32)
    lr, key = 0.3, jax.random.PRNGKey(3)
    neg_logits = _neg_logits(counts)
    jm = JW2V(negative=K, elements_algo=algo)
    j0, j1 = jm._make_step(neg_logits)(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(centers),
        jnp.asarray(contexts), jnp.asarray(lr, jnp.float32), key)
    negs = np.asarray(jax.random.categorical(key, neg_logits, shape=(B, K)))
    _inject(monkeypatch, negs)
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    t = torch.zeros((), dtype=torch.int64)
    tw2v._w2v_step(t0, t1, torch.from_numpy(centers).long(),
                   torch.from_numpy(contexts).long(),
                   torch.tensor(lr, dtype=torch.float32), t,
                   cdf=tw2v.unigram_cdf(counts, "cpu"), negative=K,
                   cbow=algo == "cbow", seed=42)
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol=0, atol=TOL)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=0, atol=TOL)
    assert int(t) == 1
    # the step moved both tables far beyond the tolerance
    assert np.abs(t0.numpy() - syn0).max() > 100 * TOL
    assert np.abs(t1.numpy() - syn1).max() > 100 * TOL


def test_one_paragraph_step_equals_the_jax_step(monkeypatch):
    """The JAX PV step is a closure inside ``ParagraphVectors.fit``: a tiny
    JAX fit records it (through ``jax.jit``), then it and the port's step
    run from the same doc vectors, ids and negatives."""
    recorded = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **k):
        recorded.append(fn)
        return real_jit(fn, *a, **k)
    sents, _, _ = _corpus(20, seed=5)
    jpv = JPV(labels=[f"D{i}" for i in range(20)], layer_size=8,
              window_size=2, min_word_frequency=1, negative=3,
              learning_rate=0.3, epochs=1, batch_size=16, seed=5,
              sentence_iter=sents)
    monkeypatch.setattr(jax, "jit", recording_jit)
    jpv.fit()
    monkeypatch.setattr(jax, "jit", real_jit)
    pv_step = jax.jit(recorded[-1])
    D, B, K = 8, 32, 3
    rng = np.random.RandomState(2)
    docs = ((rng.rand(20, D) - 0.5) / D).astype(np.float32)
    doc_ids = rng.randint(0, 20, B).astype(np.int32)
    word_ids = rng.randint(0, jpv.vocab.numWords(), B).astype(np.int32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(pv_step(jnp.asarray(docs), jnp.asarray(doc_ids),
                              jnp.asarray(word_ids),
                              jnp.asarray(0.3, jnp.float32), key))
    neg_logits = _neg_logits(jpv.vocab.counts)
    _inject(monkeypatch, np.asarray(
        jax.random.categorical(key, neg_logits, shape=(B, K))))
    syn0 = torch.from_numpy(np.array(jpv.syn0))
    got = torch.from_numpy(docs.copy())
    tw2v._pv_step(got, syn0 - syn0.mean(0), torch.from_numpy(doc_ids).long(),
                  torch.from_numpy(word_ids).long(),
                  torch.tensor(0.3, dtype=torch.float32),
                  torch.zeros((), dtype=torch.int64),
                  cdf=tw2v.unigram_cdf(jpv.vocab.counts, "cpu"), negative=K,
                  seed=7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert np.abs(got.numpy() - docs).max() > 100 * TOL


def test_negatives_follow_the_unigram_table():
    """200,000 counter-hash draws over a Zipf vocabulary of 50 against
    unigram^0.75: chi-square under df + 6 sqrt(2 df) (df = 49), every
    word drawn, and other clocks give other draws."""
    from deeplearning4j_tpu_torch.ops.normalization import StepKey
    counts = [int(1000 / (i + 1)) + 1 for i in range(50)]
    cdf = tw2v.unigram_cdf(counts, "cpu")
    negs = tw2v.draw_negatives(StepKey(42, torch.tensor(7)), cdf,
                               (40000, 5))
    assert negs.shape == (40000, 5) and negs.dtype == torch.int64
    freq = np.asarray(counts, np.float64) ** 0.75
    expected = freq / freq.sum() * negs.numel()
    observed = np.bincount(negs.flatten().numpy(), minlength=50)
    chi2 = float(((observed - expected) ** 2 / expected).sum())
    df = len(counts) - 1
    assert chi2 < df + 6 * np.sqrt(2 * df), chi2
    assert observed.min() > 0
    other = tw2v.draw_negatives(StepKey(42, torch.tensor(8)), cdf, (40000, 5))
    assert not torch.equal(negs, other)


def _same_vocab(model, jmodel):
    model.vocab = tw2v.VocabCache()
    model.vocab.word2idx = dict(jmodel.vocab.word2idx)
    model.vocab.idx2word = list(jmodel.vocab.idx2word)
    model.vocab.counts = list(jmodel.vocab.counts)


def test_the_serializer_crosses_both_ways_byte_for_byte(tmp_path):
    sents, animals, _ = _corpus(60, seed=2)
    jm = (JW2V.Builder().minWordFrequency(1).layerSize(12).windowSize(2)
          .epochs(1).batchSize(64).seed(3).iterate(sents).build())
    jm.fit()
    jpath = str(tmp_path / "jax.txt")
    JSer.writeWord2VecModel(jm, jpath)
    mine = WordVectorSerializer.readWord2VecModel(jpath, device="cpu")
    theirs = JSer.readWord2VecModel(jpath)
    assert mine.vocab.idx2word == theirs.vocab.idx2word
    np.testing.assert_array_equal(mine.syn0.numpy(), np.asarray(theirs.syn0))
    assert mine.similarity("cat", "dog") == pytest.approx(
        theirs.similarity("cat", "dog"), abs=1e-6)
    # the port writes the same bytes from the same table
    port = Word2Vec(layer_size=12, device="cpu")
    _same_vocab(port, jm)
    port.params_from_jax(np.asarray(jm.syn0), np.asarray(jm.syn1))
    ppath = str(tmp_path / "port.txt")
    WordVectorSerializer.writeWord2VecModel(port, ppath)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    back = JSer.readWord2VecModel(ppath)
    for w in animals:
        np.testing.assert_array_equal(back.getWordVector(w),
                                      theirs.getWordVector(w))
    # n-gram tokens are written with underscores, as the JAX writer does
    port.vocab.idx2word[0] = "a b"
    WordVectorSerializer.writeWord2VecModel(port, ppath)
    assert open(ppath).read().splitlines()[1].startswith("a_b ")


@pytest.fixture(scope="module")
def model():
    sents, animals, tech = _corpus()
    m = (Word2Vec.Builder()
         .minWordFrequency(2).layerSize(24).windowSize(3)
         .negativeSample(4).learningRate(0.3).epochs(25)
         .batchSize(256).seed(7)
         .iterate(sents)
         .tokenizerFactory(DefaultTokenizerFactory())
         .device("cpu")
         .build())
    m.fit()
    return m, animals, tech


def test_vocab_built(model):
    m, animals, tech = model
    for w in animals + tech:
        assert m.hasWord(w)
    assert m.getWordVector("cat").shape == (24,)
    assert m.getWordVectorMatrix().device.type == "cpu"


def test_topic_clusters_separate(model):
    """The JAX test's check at its own config: same-topic similarity must
    dominate cross-topic similarity by 0.2."""
    m, animals, tech = model
    same, cross = [], []
    for a in animals:
        for b in animals:
            if a != b:
                same.append(m.similarity(a, b))
        for t in tech:
            cross.append(m.similarity(a, t))
    assert np.mean(same) > np.mean(cross) + 0.2, \
        (np.mean(same), np.mean(cross))


def test_words_nearest(model):
    m, animals, _ = model
    near = m.wordsNearest("cat", 4)
    assert len(set(near) & set(animals)) >= 3, near


def test_fit_consumes_the_jax_draws(model):
    """The pairs, the permutations and the learning-rate schedule come
    from the JAX fit's numpy stream: the same vocabulary, and the fit's
    step count is the JAX loop's."""
    m, _, _ = model
    sents, _, _ = _corpus()
    jv = jw2v.VocabCache.build([s.split() for s in sents], 2)
    assert m.vocab.idx2word == jv.idx2word
    assert m._dispatch.scope == "nlp:word2vec"
    # eager on the CPU: nothing was captured
    assert m._dispatch.captures() == 0


def test_cbow_variant_trains():
    sents, animals, tech = _corpus(n_sent=120, seed=1)
    m = (Word2Vec.Builder()
         .minWordFrequency(2).layerSize(16).windowSize(3)
         .elementsLearningAlgorithm("CBOW")
         .epochs(2).batchSize(128).seed(3)
         .iterate(sents).device("cpu").build())
    m.fit()
    assert m.algo == "cbow"
    assert np.isfinite(m.syn0.numpy()).all()


def test_doc_vectors_cluster_by_topic():
    """The JAX ParagraphVectors test at its own config."""
    rng = np.random.RandomState(2)
    animals = ["cat", "dog", "horse", "sheep", "cow"]
    tech = ["cpu", "gpu", "tpu", "ram", "disk"]
    sents, labels = [], []
    for i in range(40):
        pool = animals if i % 2 == 0 else tech
        sents.append(" ".join(rng.choice(pool, 8)))
        labels.append(f"DOC_{i}")
    pv = ParagraphVectors(labels=labels, layer_size=16, window_size=3,
                          min_word_frequency=1, negative=4,
                          learning_rate=0.3, epochs=10, batch_size=64,
                          seed=5, sentence_iter=sents, device="cpu")
    pv.fit()
    same, cross = [], []
    for i in range(0, 40, 2):
        for j in range(0, 40, 2):
            if i != j:
                same.append(pv.similarityToLabel(f"DOC_{i}", f"DOC_{j}"))
        for j in range(1, 40, 2):
            cross.append(pv.similarityToLabel(f"DOC_{i}", f"DOC_{j}"))
    assert np.mean(same) > np.mean(cross) + 0.15, \
        (np.mean(same), np.mean(cross))
    assert pv.getDocVector("DOC_3").shape == (16,)
    assert pv._pv_dispatch.scope == "nlp:paragraph"
    with pytest.raises(ValueError, match="labels for"):
        ParagraphVectors(labels=["a"], sentence_iter=sents,
                         device="cpu").fit()


#: documents of phase 39's corpus the doc-geometry twin trains on
#: (``chip_smoke.w2v_corpus``; phase 39 itself takes 2,000)
PV_GEOMETRY_DOCS = int(os.environ.get("PV_GEOMETRY_DOCS", "120"))


def _doc_geometry(vectors, topics):
    """(mean same-topic cosine, mean cross-topic cosine) of the raw doc
    vectors and of the mean-centered ones."""
    v = np.asarray(vectors, np.float64)
    out = []
    for w in (v, v - v.mean(0)):
        u = w / np.linalg.norm(w, axis=1, keepdims=True)
        sim = u @ u.T
        same = topics[:, None] == topics[None, :]
        np.fill_diagonal(same, False)
        out += [sim[same].mean(), sim[topics[:, None] != topics[None, :]]
                .mean()]
    return np.asarray(out)


@pytest.mark.parametrize("conf", ["pv_conf", "dl4j_defaults"])
def test_doc_geometry_on_the_phase_39_corpus_equals_the_jax_one(conf):
    """ParagraphVectors of both packages on the first documents of phase
    39's corpus, at phase 39's settings (``PV_CONF``) and at DL4J's
    defaults: the mean same- and cross-topic cosines of the raw and the
    mean-centered doc vectors agree within 0.02, so the geometry (a
    shared direction in the raw vectors at ``PV_CONF``, docs that hardly
    move at the defaults) is the algorithm's, not the port's. The
    statistics are printed (``-s``; ``PV_GEOMETRY_DOCS`` sets the
    slice)."""
    import chip_smoke
    sents, topics = chip_smoke.w2v_corpus()
    sents, topics = sents[:PV_GEOMETRY_DOCS], topics[:PV_GEOMETRY_DOCS]
    kw = dict(chip_smoke.PV_CONF) if conf == "pv_conf" else {}
    labels = [f"DOC_{i}" for i in range(len(sents))]
    got = {}
    for name, cls, extra in (("jax", JPV, {}), ("port", ParagraphVectors,
                                                {"device": "cpu"})):
        pv = cls(labels=labels, sentence_iter=sents, **kw, **extra).fit()
        dv = pv.doc_vectors
        got[name] = _doc_geometry(
            dv.numpy() if isinstance(dv, torch.Tensor) else np.asarray(dv),
            topics)
        print(f"{name} {conf} on {len(sents)} docs: raw same "
              f"{got[name][0]:.4f} cross {got[name][1]:.4f} margin "
              f"{got[name][0] - got[name][1]:.4f}; mean-centered same "
              f"{got[name][2]:.4f} cross {got[name][3]:.4f} margin "
              f"{got[name][2] - got[name][3]:.4f}")
    np.testing.assert_allclose(got["port"], got["jax"], atol=0.02)


def test_sequence_vectors_is_word2vec():
    assert issubclass(SequenceVectors, Word2Vec)


def test_the_mesh_seams_raise(model):
    """The mesh seams take a mesh now: on a one-rank mesh the tables stay
    whole (nothing splits over a model axis of 1) and every query
    answers as before."""
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel import init
    m, _, _ = model
    prev = init._initialized
    if prev is None:
        init.initializeDistributed(device="cpu")
    try:
        mesh = DeviceMesh.create(data=1, model=1)
        assert Word2Vec(mesh=mesh, device="cpu").mesh is mesh
        assert Word2Vec.Builder().mesh(mesh).device("cpu").build().mesh \
            is mesh
        sim = m.similarity("cat", "dog")
        table = m.getWordVectorMatrix().clone()
        assert m.shard_over_mesh(mesh) is m
        assert m.similarity("cat", "dog") == sim
        assert torch.equal(m.getWordVectorMatrix(), table)
    finally:
        if prev is None:
            init._initialized = None


def rank_w2v(sents, sharded):
    """The JAX mesh test's Word2Vec fit on this rank: tables split over
    ``model`` (``sharded``) or replicated; the whole ``syn0``, the
    similarity of cat and dog and what this rank holds of syn0."""
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    mesh = DeviceMesh.create(data=1, model=2) if sharded else None
    m = (Word2Vec.Builder()
         .minWordFrequency(2).layerSize(32).windowSize(3)
         .negativeSample(4).learningRate(0.3).epochs(4)
         .batchSize(128).seed(11)
         .iterate(sents).mesh(mesh).device("cpu")
         .build())
    m.fit()
    return (m.getWordVectorMatrix().numpy(), m.similarity("cat", "dog"),
            tuple(m.syn0.shape))


def rank_w2v_shard_vocab(sents):
    """A replicated fit, then its tables split over ``model`` along the
    vocabulary: what this rank holds, and the queries before and
    after."""
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    m = (Word2Vec.Builder()
         .minWordFrequency(2).layerSize(24).windowSize(3)
         .negativeSample(4).learningRate(0.3).epochs(2)
         .batchSize(256).seed(7)
         .iterate(sents).device("cpu")
         .build())
    m.fit()
    before = (m.similarity("cat", "dog"), m.wordsNearest("cat", 3))
    m.shard_over_mesh(DeviceMesh.create(data=1, model=2))
    after = (m.similarity("cat", "dog"), m.wordsNearest("cat", 3))
    return before, after, tuple(m.syn0.shape), m.vocab.numWords()


class TestWord2VecOnMesh:
    @pytest.fixture(scope="class")
    def pool(self, tmp_path_factory):
        from deeplearning4j_tpu_torch.parallel.launch import RankPool
        with RankPool(2, str(tmp_path_factory.mktemp("store")),
                      device="cpu") as p:
            yield p

    def test_sharded_embeddings_on_mesh(self, pool):
        """The vocabulary split over model=2 (zero-padded to even): each
        rank holds half the rows; the queries answer as before."""
        sents, _, _ = _corpus()
        for before, after, shape, V in pool.run(rank_w2v_shard_vocab,
                                                sents):
            assert before[0] == pytest.approx(after[0], rel=1e-6)
            assert before[1] == after[1]
            assert shape[0] == -(-V // 2)

    def test_mesh_sharded_TRAINING_matches_replicated(self, pool):
        """The JAX test: the same seed gives the same vectors as
        replicated training, the tables split through every step (JAX:
        model=8 over 8 devices; here model=2 over 2 ranks)."""
        sents, _, _ = _corpus()
        rep = pool.run(rank_w2v, sents, False, ranks=[0])[0]
        for syn0, sim, local in pool.run(rank_w2v, sents, True):
            assert local == (rep[0].shape[0], 16)
            np.testing.assert_allclose(syn0, rep[0], rtol=2e-4, atol=1e-5)
            np.testing.assert_allclose(sim, rep[1], rtol=1e-3)


def test_word2vec_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Word2Vec()
    assert Word2Vec(device="cpu").device.type == "cpu"


def test_params_from_jax_copy_into_the_tables():
    """Tables cross as numpy arrays; once a table exists its storage is
    kept (a captured step holds its address)."""
    rng = np.random.RandomState(0)
    syn0, syn1 = rng.randn(6, 4).astype(np.float32), \
        rng.randn(6, 4).astype(np.float32)
    docs = rng.randn(3, 4).astype(np.float32)
    pv = ParagraphVectors(labels=["a", "b", "c"], layer_size=4, device="cpu")
    pv.params_from_jax(syn0, syn1, docs)
    held = pv.syn0
    pv.params_from_jax(syn0 * 2)
    assert pv.syn0 is held
    np.testing.assert_array_equal(pv.syn0.numpy(), syn0 * 2)
    np.testing.assert_array_equal(pv.syn1.numpy(), syn1)
    np.testing.assert_array_equal(pv.getDocVector("b"), docs[1])
