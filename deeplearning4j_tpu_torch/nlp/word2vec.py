"""Word2Vec / SequenceVectors / ParagraphVectors — the port of
``deeplearning4j_tpu/nlp/word2vec.py``.

Reference parity: ``org.deeplearning4j.models.word2vec.Word2Vec`` (+
``SequenceVectors``, ``ParagraphVectors`` of ``deeplearning4j-nlp``):
Builder API (minWordFrequency, layerSize, windowSize, negative sampling,
CBOW/SkipGram), ``VocabCache``, ``wordsNearest``/``similarity``, and
``WordVectorSerializer``'s text format, byte for byte the JAX package's.

Training on the card: an epoch's (center, context) pairs are made on the
host with the JAX package's numpy draws (the same vocabulary, windows and
permutations from the same seed), uploaded once, and cut into batches;
the tail is padded to the batch size, so one signature covers the whole
fit. Each batch is one skip-gram (or pairwise CBOW) step with negative
sampling, ``_w2v_step(syn0, syn1, centers, contexts, lr, t)``, which
updates both tables in place: the gradients are the gathers' scatter-adds
(``index_add_``, the JAX ``segment_sum``; on the card that scatter-add is
atomic, so repeated words sum in varying order). ``lr`` and the step clock
``t`` are device scalars. The step runs through
:class:`~..nn.compilecache.CachedDispatch` (scope ``"nlp:word2vec"``,
``"nlp:paragraph"`` for the doc vectors): one captured CUDA graph
replayed a batch on the card, eagerly on the CPU.

Negatives: where the JAX step draws ``jax.random.categorical`` over the
unigram^0.75 logits, the port draws from its counter hash
(``ops.normalization.hash24`` keyed by ``StepKey(seed, t)``) by inverse
CDF over the unigram^0.75 table (:func:`draw_negatives`, looked up at each
call, so parity tests inject the JAX draws). No ``torch.Generator`` is
involved, so a captured step needs none; the streams differ from
threefry's, so parity is by injected negatives and by a chi-square bound.

Over a mesh (``Word2Vec(mesh=)`` / ``Builder().mesh(m)``): ``syn0`` and
``syn1`` are split along the layer dim over the ``model`` axis (JAX
word2vec.py:91-97, :161-163), each rank holding ``D/model`` columns of
both. A pair's dot products are partial sums over the rank's columns,
joined by one small all-reduce a step (every score of the batch in one
message; the JAX step's psum); the negatives are the same on every rank
(one key), and each rank updates its own columns. The step runs eagerly
there: gloo's host-staged all-reduce cannot be captured.
:meth:`Word2Vec.shard_over_mesh` splits both tables along the
vocabulary instead (JAX :274-295), zero-padded to the axis's multiple;
queries gather them back.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.tokenization import (DefaultTokenizerFactory,
                                                       TokenizerFactory)
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.ops.normalization import StepKey, hash24

class VocabCache:
    """ref: org.deeplearning4j.models.word2vec.wordstore.VocabCache."""

    def __init__(self):
        self.word2idx: Dict[str, int] = {}
        self.idx2word: List[str] = []
        self.counts: List[int] = []

    @staticmethod
    def build(token_lists: Iterable[List[str]], min_word_frequency: int
              ) -> "VocabCache":
        counter: Counter = Counter()
        for toks in token_lists:
            counter.update(toks)
        vc = VocabCache()
        for w, c in counter.most_common():
            if c >= min_word_frequency:
                vc.word2idx[w] = len(vc.idx2word)
                vc.idx2word.append(w)
                vc.counts.append(c)
        return vc

    def numWords(self) -> int:
        return len(self.idx2word)

    def containsWord(self, w: str) -> bool:
        return w in self.word2idx

    def indexOf(self, w: str) -> int:
        return self.word2idx.get(w, -1)

    def wordAtIndex(self, i: int) -> str:
        return self.idx2word[i]


def _pairs_from_ids(ids: np.ndarray, window: int, rng: np.random.RandomState
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(center, context) pairs with the reference's random window shrink."""
    centers, contexts = [], []
    n = len(ids)
    spans = rng.randint(1, window + 1, n)
    for i in range(n):
        b = spans[i]
        for j in range(max(0, i - b), min(n, i + b + 1)):
            if j != i:
                centers.append(ids[i])
                contexts.append(ids[j])
    return (np.asarray(centers, np.int32), np.asarray(contexts, np.int32))


# ------------------------------------------------------------- the steps
def unigram_cdf(counts: Sequence[int], device) -> torch.Tensor:
    """The cumulative unigram^0.75 distribution (the reference's negative
    table), float64 on ``device``."""
    freq = np.asarray(counts, np.float64) ** 0.75
    return torch.from_numpy(np.cumsum(freq / freq.sum())).to(device)


def draw_negatives(key: StepKey, cdf: torch.Tensor, shape) -> torch.Tensor:
    """Negative word ids of ``shape`` drawn from ``key`` alone: a
    :func:`hash24` uniform on the 2^-24 grid per draw, mapped through the
    inverse of ``cdf``."""
    n = int(np.prod(shape))
    u = hash24(key, n, cdf.device).double() * (2.0 ** -24)
    idx = torch.searchsorted(cdf, u, right=True)
    return idx.clamp_(max=cdf.shape[0] - 1).reshape(tuple(shape))


def _sgns_grads(v, u_pos, u_neg, group=None):
    """Gradients of ``-(mean log s(v.u_pos) + mean sum_k log s(-v.u_neg))``
    (the JAX step's loss) with respect to ``v``, ``u_pos`` and ``u_neg``.
    With ``group`` the rows hold this rank's columns: the scores are
    summed over the group (one all-reduce) before the gradients."""
    B = v.shape[0]
    sp = (v * u_pos).sum(-1)
    sn = torch.einsum("bd,bkd->bk", v, u_neg)
    if group is not None:
        from deeplearning4j_tpu_torch.parallel import collectives
        both = collectives.all_reduce(torch.cat([sp[:, None], sn], 1),
                                      group)
        sp, sn = both[:, 0], both[:, 1:]
    gsp = -torch.sigmoid(-sp) / B
    gsn = torch.sigmoid(sn) / B
    g_v = gsp[:, None] * u_pos + torch.einsum("bk,bkd->bd", gsn, u_neg)
    return g_v, gsp[:, None] * v, gsn[:, :, None] * v[:, None, :]


def _w2v_step(syn0, syn1, centers, contexts, lr, t, *, cdf, negative,
              cbow, seed, group=None):
    """One skip-gram step (CBOW: pairwise context -> center, the
    pair-sampled equivalent the reference's CBOW batches reduce to) with
    negative sampling: both tables and the clock updated in place (with
    ``group``, this rank's columns of them)."""
    inp = contexts if cbow else centers
    out = centers if cbow else contexts
    neg = draw_negatives(StepKey(seed, t), cdf, (inp.shape[0], negative))
    v, u_pos, u_neg = syn0[inp], syn1[out], syn1[neg]
    g_v, g_pos, g_neg = _sgns_grads(v, u_pos, u_neg, group)
    step = -lr
    syn0.index_add_(0, inp, g_v * step)
    syn1.index_add_(0, out, g_pos * step)
    syn1.index_add_(0, neg.reshape(-1),
                    (g_neg * step).reshape(-1, syn1.shape[1]))
    t.add_(1)


def _pv_step(docs, table, doc_ids, word_ids, lr, t, *, cdf, negative, seed):
    """One PV-DBOW step: the doc vectors (only) against the fixed,
    mean-centered word table."""
    neg = draw_negatives(StepKey(seed, t), cdf, (doc_ids.shape[0], negative))
    g_v, _, _ = _sgns_grads(docs[doc_ids], table[word_ids], table[neg])
    docs.index_add_(0, doc_ids, g_v * -lr)
    t.add_(1)


class Word2Vec:
    """ref: org.deeplearning4j.models.word2vec.Word2Vec. Trains on
    ``device`` (``cuda`` unless the caller names another)."""

    def __init__(self, layer_size=100, window_size=5, min_word_frequency=5,
                 negative=5, learning_rate=0.025, min_learning_rate=1e-4,
                 iterations=1, epochs=1, batch_size=512, seed=42,
                 elements_algo="skipgram", tokenizer: TokenizerFactory = None,
                 sentence_iter=None, mesh=None, device=None):
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh.device
        self._table_mesh = None     # the mesh the tables are split over
        self.layer_size = layer_size
        self.window = window_size
        self.min_word_frequency = min_word_frequency
        self.negative = negative
        self.lr = learning_rate
        self.min_lr = min_learning_rate
        self.iterations = iterations
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.algo = elements_algo.lower()
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.sentences = sentence_iter
        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[torch.Tensor] = None   # input embeddings [V, D]
        self.syn1: Optional[torch.Tensor] = None   # output embeddings [V, D]
        self._dispatch: Optional[cc.CachedDispatch] = None

    # ---------------------------------------------------------- Builder API
    class Builder:
        def __init__(self):
            self._kw = {}

        def minWordFrequency(self, v): self._kw["min_word_frequency"] = v; return self
        def layerSize(self, v): self._kw["layer_size"] = v; return self
        def windowSize(self, v): self._kw["window_size"] = v; return self
        def negativeSample(self, v): self._kw["negative"] = int(v); return self
        def learningRate(self, v): self._kw["learning_rate"] = v; return self
        def minLearningRate(self, v): self._kw["min_learning_rate"] = v; return self
        def iterations(self, v): self._kw["iterations"] = v; return self
        def epochs(self, v): self._kw["epochs"] = v; return self
        def batchSize(self, v): self._kw["batch_size"] = v; return self
        def seed(self, v): self._kw["seed"] = v; return self
        def elementsLearningAlgorithm(self, name):
            self._kw["elements_algo"] = ("cbow" if "cbow" in str(name).lower()
                                         else "skipgram")
            return self

        def tokenizerFactory(self, tf): self._kw["tokenizer"] = tf; return self
        def mesh(self, m): self._kw["mesh"] = m; return self
        def device(self, d): self._kw["device"] = d; return self
        def iterate(self, sentence_iter):
            self._kw["sentence_iter"] = sentence_iter
            return self

        def build(self) -> "Word2Vec":
            return Word2Vec(**self._kw)

    # ------------------------------------------------------------- training
    def _token_lists(self) -> List[List[str]]:
        return [self.tokenizer.create(sent).getTokens()
                for sent in self.sentences]

    def _load_table(self, name: str, arr) -> None:
        """Copy a numpy table onto the device, into the table's own
        storage once it exists (a captured step keeps its addresses)."""
        t = torch.from_numpy(np.array(arr, np.float32))
        cur = getattr(self, name)
        if cur is not None and cur.shape == t.shape:
            cur.copy_(t)
        else:
            setattr(self, name, t.to(self.device))

    def params_from_jax(self, syn0, syn1=None) -> "Word2Vec":
        """Copy tables (numpy arrays, e.g. a JAX model's ``syn0``/``syn1``)
        onto this model's device."""
        for name, arr in (("syn0", syn0), ("syn1", syn1)):
            if arr is not None:
                self._load_table(name, arr)
        return self

    def _step_fn(self, cdf):
        """The training step as the dispatch calls it: the tables and the
        clock are its state, read and written in place."""
        group = self.mesh.group("model") \
            if self._table_mesh is not None else None
        kw = dict(cdf=cdf, negative=self.negative, cbow=self.algo == "cbow",
                  seed=self.seed, group=group)

        def step(centers, contexts, lr):
            _w2v_step(self.syn0, self.syn1, centers, contexts, lr, self._t,
                      **kw)
        return step

    def fit(self):
        token_lists = self._token_lists()
        self.vocab = VocabCache.build(token_lists, self.min_word_frequency)
        V, D = self.vocab.numWords(), self.layer_size
        if V == 0:
            raise ValueError("empty vocabulary (min_word_frequency too high?)")
        rng = np.random.RandomState(self.seed)
        dev = self.device
        self.syn0 = torch.from_numpy(
            (rng.rand(V, D).astype(np.float32) - 0.5) / D).to(dev)
        self.syn1 = torch.zeros((V, D), dtype=torch.float32, device=dev)
        self._table_mesh = None
        if self.mesh is not None and self.mesh.size("model") > 1:
            from deeplearning4j_tpu_torch.parallel.mesh import place_by_spec
            self.syn0 = place_by_spec(self.mesh, self.syn0, (None, "model"))
            self.syn1 = place_by_spec(self.mesh, self.syn1, (None, "model"))
            self._table_mesh = self.mesh
        self._t = torch.zeros((), dtype=torch.int64, device=dev)
        cdf = unigram_cdf(self.vocab.counts, dev)

        ids_per_sent = [np.asarray([self.vocab.indexOf(t) for t in toks
                                    if self.vocab.containsWord(t)], np.int32)
                        for toks in token_lists]
        step = self._step_fn(cdf)
        self._dispatch = step if self._table_mesh is not None else \
            cc.CachedDispatch(step, "nlp:word2vec",
                              state=lambda: [self.syn0, self.syn1, self._t],
                              always_capture=True)
        total_updates = 0
        n_steps_est = max(1, self.epochs * self.iterations * sum(
            max(len(s) - 1, 0) for s in ids_per_sent) * 2 * (
                (self.window + 1) // 2) // self.batch_size)
        bs = self.batch_size
        for _ in range(self.epochs):
            for _ in range(self.iterations):
                centers, contexts = [], []
                for ids in ids_per_sent:
                    if len(ids) < 2:
                        continue
                    c, t = _pairs_from_ids(ids, self.window, rng)
                    centers.append(c)
                    contexts.append(t)
                if not centers:
                    raise ValueError(
                        "no training pairs: every sentence has fewer than "
                        "two in-vocabulary tokens (lower min_word_frequency "
                        "or provide longer sentences)")
                centers = np.concatenate(centers)
                contexts = np.concatenate(contexts)
                perm = rng.permutation(len(centers))
                centers, contexts = centers[perm], contexts[perm]
                n_batches = -(-len(centers) // bs)
                # pad the tail with its first pair, as the JAX fit does
                tail = (n_batches - 1) * bs
                reps = n_batches * bs - len(centers)
                centers = np.concatenate([centers,
                                          centers[tail:tail + 1].repeat(reps)])
                contexts = np.concatenate(
                    [contexts, contexts[tail:tail + 1].repeat(reps)])
                lrs = np.asarray(
                    [max(self.min_lr, self.lr * (1 - (total_updates + i)
                                                 / max(n_steps_est, 1)))
                     for i in range(n_batches)], np.float32)
                # one upload an epoch; a batch is a slice on the device
                c_dev = torch.from_numpy(centers.astype(np.int64)).to(dev)
                t_dev = torch.from_numpy(contexts.astype(np.int64)).to(dev)
                lr_dev = torch.from_numpy(lrs).to(dev)
                for i in range(n_batches):
                    self._dispatch(c_dev[i * bs:(i + 1) * bs],
                                   t_dev[i * bs:(i + 1) * bs], lr_dev[i])
                total_updates += n_batches
        return self

    # ------------------------------------------------------------- querying
    def getWordVectorMatrix(self) -> torch.Tensor:
        """``syn0`` whole (gathered when it is split over a mesh)."""
        if self._table_mesh is not None:
            return self._table_mesh.gather(self.syn0)
        return self.syn0

    def _host_table(self) -> np.ndarray:
        return self.getWordVectorMatrix().detach().cpu().numpy()

    def getWordVector(self, word: str) -> np.ndarray:
        i = self.vocab.indexOf(word)
        if i < 0:
            raise KeyError(word)
        if self._table_mesh is not None:
            return self._host_table()[i]
        return self.syn0[i].detach().cpu().numpy()

    def hasWord(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.containsWord(word)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.getWordVector(a), self.getWordVector(b)
        return float(np.dot(va, vb)
                     / max(np.linalg.norm(va) * np.linalg.norm(vb), 1e-12))

    def wordsNearest(self, word: str, n: int = 10) -> List[str]:
        i = self.vocab.indexOf(word)
        if i < 0:
            raise KeyError(word)
        m = self._host_table()[:self.vocab.numWords()]
        norms = np.linalg.norm(m, axis=1) + 1e-12
        sims = (m @ m[i]) / (norms * norms[i])
        order = np.argsort(-sims)
        return [self.vocab.wordAtIndex(j) for j in order
                if j != i][:n]

    def shard_over_mesh(self, mesh):
        """Split both tables over the mesh's ``model`` axis along the
        VOCAB dim (ref: the 'sharded parameter server' row: a vocabulary
        past one card's memory), the vocab dim zero-padded up to a
        multiple of the axis size (padding rows are never indexed: ids <
        numWords). Queries gather the tables back."""
        from deeplearning4j_tpu_torch.parallel.mesh import place_by_spec
        axis = mesh.size("model")
        t0 = self.getWordVectorMatrix()
        t1 = self.syn1 if self._table_mesh is None \
            else self._table_mesh.gather(self.syn1)
        V = int(t0.shape[0])
        padded = -(-V // axis) * axis
        if padded != V:
            pad = torch.zeros((padded - V, t0.shape[1]), dtype=t0.dtype,
                              device=t0.device)
            t0, t1 = torch.cat([t0, pad]), torch.cat([t1, pad])
        self.syn0 = place_by_spec(mesh, t0, ("model", None))
        self.syn1 = place_by_spec(mesh, t1, ("model", None))
        self._table_mesh = mesh if axis > 1 else None
        return self


class SequenceVectors(Word2Vec):
    """ref: org.deeplearning4j.models.sequencevectors.SequenceVectors —
    Word2Vec generalized to arbitrary symbol sequences: feed any iterable
    of whitespace-joined element sequences."""


class ParagraphVectors(Word2Vec):
    """PV-DBOW (ref: org.deeplearning4j.models.paragraphvectors.
    ParagraphVectors): document vectors trained to predict the document's
    words with negative sampling; word vectors co-train as in skip-gram."""

    def __init__(self, labels: Sequence[str] = None, **kw):
        super().__init__(**kw)
        self.labels = list(labels) if labels else None
        self.doc_vectors: Optional[torch.Tensor] = None
        self._pv_dispatch: Optional[cc.CachedDispatch] = None

    def params_from_jax(self, syn0, syn1=None, doc_vectors=None
                        ) -> "ParagraphVectors":
        super().params_from_jax(syn0, syn1)
        if doc_vectors is not None:
            self._load_table("doc_vectors", doc_vectors)
        return self

    def fit(self):
        token_lists = self._token_lists()
        if self.labels is None:
            self.labels = [f"DOC_{i}" for i in range(len(token_lists))]
        if len(self.labels) != len(token_lists):
            raise ValueError(
                f"{len(self.labels)} labels for {len(token_lists)} "
                f"documents")
        super().fit()
        D, dev = self.layer_size, self.device
        rng = np.random.RandomState(self.seed + 1)
        self.doc_vectors = torch.from_numpy(
            (rng.rand(len(self.labels), D).astype(np.float32) - 0.5) / D
        ).to(dev)
        cdf = unigram_cdf(self.vocab.counts, dev)
        # doc vectors train against the MEAN-CENTERED word table: the raw
        # table carries a large shared direction (all similarities
        # positive) that would dominate every doc's optimum
        table = self.syn0 - self.syn0.mean(0)
        self._pv_t = torch.zeros((), dtype=torch.int64, device=dev)
        kw = dict(cdf=cdf, negative=self.negative, seed=self.seed + 2)

        def step(doc_ids, word_ids, lr):
            _pv_step(self.doc_vectors, table, doc_ids, word_ids, lr,
                     self._pv_t, **kw)
        self._pv_dispatch = cc.CachedDispatch(
            step, "nlp:paragraph",
            state=lambda: [self.doc_vectors, self._pv_t],
            always_capture=True)
        rngp = np.random.RandomState(self.seed + 3)
        pairs_d, pairs_w = [], []
        for d, toks in enumerate(token_lists):
            for t in toks:
                i = self.vocab.indexOf(t)
                if i >= 0:
                    pairs_d.append(d)
                    pairs_w.append(i)
        pairs_d = np.asarray(pairs_d, np.int64)
        pairs_w = np.asarray(pairs_w, np.int64)
        bs = min(self.batch_size, max(len(pairs_d), 1))
        lr = torch.full((), self.lr, dtype=torch.float32, device=dev)
        for _ in range(self.epochs * 4):
            perm = rngp.permutation(len(pairs_d))
            n = (len(perm) // bs) * bs           # full batches only
            d_dev = torch.from_numpy(pairs_d[perm[:n]]).to(dev)
            w_dev = torch.from_numpy(pairs_w[perm[:n]]).to(dev)
            for s in range(0, n, bs):
                self._pv_dispatch(d_dev[s:s + bs], w_dev[s:s + bs], lr)
        return self

    def getDocVector(self, label: str) -> np.ndarray:
        return self.doc_vectors[self.labels.index(label)].detach().cpu() \
            .numpy()

    def similarityToLabel(self, text_label_a: str, text_label_b: str) -> float:
        va = self.getDocVector(text_label_a)
        vb = self.getDocVector(text_label_b)
        return float(np.dot(va, vb)
                     / max(np.linalg.norm(va) * np.linalg.norm(vb), 1e-12))


class WordVectorSerializer:
    """ref: org.deeplearning4j.models.embeddings.loader.WordVectorSerializer
    — the word2vec TEXT format (one 'word v1 v2 ...' line, optional header),
    written and read byte for byte as the JAX package does."""

    @staticmethod
    def writeWord2VecModel(model: Word2Vec, path: str):
        m = model._host_table()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        V = model.vocab.numWords()
        with open(path, "w") as f:
            f.write(f"{V} {m.shape[1]}\n")
            for i in range(V):
                w = model.vocab.wordAtIndex(i)
                if " " in w:
                    # the word2vec text format is space-delimited; n-gram
                    # tokens use the conventional underscore join
                    w = w.replace(" ", "_")
                vec = " ".join(f"{v:.6f}" for v in m[i])
                f.write(f"{w} {vec}\n")

    @staticmethod
    def readWord2VecModel(path: str, device=None) -> Word2Vec:
        with open(path) as f:
            first = f.readline().split()
            has_header = len(first) == 2 and all(p.isdigit() for p in first)
            rows: List[Tuple[str, np.ndarray]] = []
            if not has_header:
                rows.append((first[0],
                             np.asarray([float(v) for v in first[1:]],
                                        np.float32)))
            for line in f:
                parts = line.rstrip("\n").split(" ")
                rows.append((parts[0],
                             np.asarray([float(v) for v in parts[1:]],
                                        np.float32)))
        model = Word2Vec(layer_size=len(rows[0][1]), device=device)
        model.vocab = VocabCache()
        vecs = []
        for w, v in rows:
            model.vocab.word2idx[w] = len(model.vocab.idx2word)
            model.vocab.idx2word.append(w)
            model.vocab.counts.append(1)
            vecs.append(v)
        model.syn0 = torch.from_numpy(np.stack(vecs)).to(model.device)
        model.syn1 = torch.zeros_like(model.syn0)
        return model
