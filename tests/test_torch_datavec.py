"""The port's DataVec (``deeplearning4j_tpu_torch/data/records.py``)
against the JAX package's on the CPU: every case of
``tests/test_datavec_ext.py``, ``tests/test_image.py::
TestTransformProcessNewOps`` and ``tests/test_quick_smoke.py::
test_datavec_transform_process`` runs through both packages, which must
give the same rows, schemas and batches — equal values of the same
types, features, labels and masks bit-equal — and the values those tests
assert. Then ``chip_smoke.py`` phase 32's tabular and sequence paths at
a small size (2,048 transactions, 60 control charts): both packages'
batches bit-equal, and two steps of the port's net from the JAX net's
parameters held to the JAX steps (losses and outputs 1e-5, params after
the steps 2e-4: tests/test_pallas.py's tolerances).

Where DataVec and the JAX package differ the port follows the JAX
package (its module docstring lists them); the pins are here:
``stringToTimeTransform``'s strptime format read as UTC and
``hourOfDay``, ``normalize``'s float64 over the rows given, and
``SequenceRecordReaderDataSetIterator`` ignoring ``setPreProcessor``.
"""

import math
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import records as J
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import NormalizerStandardize as JNorm
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data import datavec_fixtures as fx
from deeplearning4j_tpu_torch.data import records as T
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.dataset import NormalizerStandardize
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

FWD_TOL = 1e-5
FIT_TOL = 2e-4


def _same(got, want, path="out"):
    """Equal values of the same type all the way down (a Writable by its
    class name and value, a float bit-equal or both NaN)."""
    if isinstance(want, (J.Writable, T.Writable)):
        assert type(got).__name__ == type(want).__name__, path
        _same(got.value, want.value, path + ".value")
        return
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k!r}]")
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert np.array_equal(got, want, equal_nan=True), path
        return
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert got == want, (path, got, want)


def _both(run):
    """``run(records module)`` through both packages; the port's result,
    which must be the JAX result."""
    got, want = run(T), run(J)
    _same(got, want)
    return got


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, DataSet)
        for f in ("features", "labels", "features_mask", "labels_mask"):
            a, b = getattr(g, f), getattr(w, f)
            if b is None:
                assert a is None, f
            else:
                _same(a, np.asarray(b), f)


def _schema(R, *cols):
    b = R.Schema.Builder()
    for name, kind in cols:
        getattr(b, f"addColumn{kind}")(name)
    return b.build()


# ----------------------------------------------- test_datavec_ext.py's cases
class TestNewColumnTransforms:
    def test_numeric_additions(self):
        rows = _both(lambda R: (R.TransformProcess.Builder(
            _schema(R, ("x", "Double"))).absValueColumn("x")
            .roundDoubleColumn("x", 1).build()).execute([[-1.26], [2.71]]))
        assert rows == [[1.3], [2.7]]

    def test_subtract_mean_and_replace_empty(self):
        rows = _both(lambda R: R.TransformProcess.Builder(
            _schema(R, ("x", "Double"))).subtractMean("x").build()
            .execute([[1.0], [3.0]]))
        assert rows == [[-1.0], [1.0]]
        rows = _both(lambda R: R.TransformProcess.Builder(
            _schema(R, ("s", "String"))).replaceEmptyWithValue(
                "s", "missing").build().execute([[""], ["a"]]))
        assert rows == [["missing"], ["a"]]

    def test_string_additions(self):
        def run(R):
            tp = (R.TransformProcess.Builder(_schema(R, ("s", "String")))
                  .trimStringTransform("s")
                  .padStringTransform("s", 5, "0", "LEFT")
                  .substringTransform("s", 1, 4)
                  .stringLengthColumn("s", "len")
                  .build())
            return tp.execute([[" 42 "], ["abcdef"]]), \
                tp.getFinalSchema().getColumnNames()
        rows, names = _both(run)
        assert rows[0] == ["004", 3] and names == ["s", "len"]

    def test_map_all_strings_except(self):
        rows = _both(lambda R: R.TransformProcess.Builder(
            _schema(R, ("s", "String"))).mapAllStringsExceptList(
                "s", "OTHER", ["a", "b"]).build().execute(
                    [["a"], ["z"], ["b"]]))
        assert rows == [["a"], ["OTHER"], ["b"]]

    def test_onehot_roundtrip(self):
        def run(R):
            sch = _schema(R, ("pre", "Integer"), ("color", "Categorical"),
                          ("post", "Integer"))
            sch.columns[1]["states"] = ["blue", "green", "red"]
            tp = (R.TransformProcess.Builder(sch)
                  .categoricalToOneHot("color")
                  .oneHotToCategorical("color", "color[blue]",
                                       "color[green]", "color[red]")
                  .build())
            return tp.execute([[7, "green", 1], [8, "red", 2]]), \
                tp.getFinalSchema().columns
        rows, cols = _both(run)
        assert rows == [[7, "green", 1], [8, "red", 2]]
        assert cols[1]["states"] == ["blue", "green", "red"]

    def test_filter_invalid_and_cond_copy(self):
        rows = _both(lambda R: R.TransformProcess.Builder(
            _schema(R, ("a", "Double"), ("b", "Double")))
            .filterInvalidValues("a")
            .conditionalCopyValueTransform("b", "a", lambda v: v < 0)
            .build().execute([[1.0, -5.0], ["bad", 2.0], [3.0, 4.0]]))
        assert rows == [[1.0, 1.0], [3.0, 4.0]]


class TestReducer:
    def test_group_by_aggregation(self):
        def run(R):
            sch = _schema(R, ("key", "String"), ("v", "Double"),
                          ("w", "Double"))
            red = (R.Reducer.Builder("key").sumColumns("v").meanColumns("w")
                   .countColumns("v").build())
            tp = R.TransformProcess.Builder(sch).reduce(red).build()
            return tp.execute([["a", 1.0, 10.0], ["b", 5.0, 2.0],
                               ["a", 2.0, 20.0]]), tp.getFinalSchema().columns
        rows, cols = _both(run)
        assert rows == [["a", 3.0, 15.0, 2], ["b", 5.0, 2.0, 1]]
        assert [c["name"] for c in cols] == \
            ["key", "sum(v)", "mean(w)", "count(v)"]


class TestJoin:
    LEFT = [[1, 0.5], [2, 1.5]]
    RIGHT = [[2, 9.0], [3, 8.0]]

    @staticmethod
    def _join(R, kind):
        return (R.Join.Builder(kind).setJoinColumns("id")
                .setSchemas(_schema(R, ("id", "Integer"), ("x", "Double")),
                            _schema(R, ("id", "Integer"), ("y", "Double")))
                .build())

    def test_inner(self):
        out, names = _both(lambda R: (
            R.executeJoin(self._join(R, "Inner"), self.LEFT, self.RIGHT),
            self._join(R, "Inner").outputSchema().getColumnNames()))
        assert out == [[2, 1.5, 9.0]] and names == ["id", "x", "y"]

    def test_left_right_full(self):
        out = _both(lambda R: [R.executeJoin(self._join(R, k), self.LEFT,
                                             self.RIGHT)
                               for k in ("LeftOuter", "RightOuter",
                                         "FullOuter")])
        assert out == [[[1, 0.5, None], [2, 1.5, 9.0]],
                       [[2, 1.5, 9.0], [3, None, 8.0]],
                       [[1, 0.5, None], [2, 1.5, 9.0], [3, None, 8.0]]]
        for R in (T, J):
            with pytest.raises(ValueError, match="unknown join type"):
                R.Join.Builder("Cross")


class TestSequenceOps:
    ROWS = [["a", 2, 3.0], ["a", 0, 1.0], ["b", 0, 10.0],
            ["a", 1, 2.0], ["b", 1, 20.0]]

    @staticmethod
    def _seq(R):
        return R.TransformProcess.Builder(_schema(
            R, ("dev", "String"), ("t", "Integer"), ("v", "Double"))
        ).convertToSequence("dev", "t")

    def test_convert_to_sequence_sorts(self):
        seqs = _both(lambda R: self._seq(R).build().execute(self.ROWS))
        assert [[r[2] for r in s] for s in seqs] == [[1.0, 2.0, 3.0],
                                                     [10.0, 20.0]]

    def test_window_pad_trim_offset_reverse(self):
        padded = _both(lambda R: self._seq(R).padSequenceToLength(4, 0)
                       .build().execute(self.ROWS))
        assert all(len(s) == 4 for s in padded)
        wins = _both(lambda R: self._seq(R).window(2, 1).build()
                     .execute(self.ROWS))
        assert [[r[2] for r in w] for w in wins] == \
            [[1.0, 2.0], [2.0, 3.0], [10.0, 20.0]]
        trimmed = _both(lambda R: self._seq(R).trimSequence(1).build()
                        .execute(self.ROWS))
        assert [[r[2] for r in s] for s in trimmed] == [[2.0, 3.0], [20.0]]
        rev = _both(lambda R: self._seq(R).reverseSequence().build()
                    .execute(self.ROWS))
        assert [r[2] for r in rev[0]] == [3.0, 2.0, 1.0]
        off = _both(lambda R: self._seq(R).offsetSequence(
            "v", -1, pad_value=-1.0).build().execute(self.ROWS))
        assert [r[2] for r in off[0]] == [2.0, 3.0, -1.0]

    def test_diff_moving_split(self):
        diff = _both(lambda R: self._seq(R).sequenceDifference("v").build()
                     .execute(self.ROWS))
        assert [r[2] for r in diff[0]] == [0.0, 1.0, 1.0]

        def moving(R):
            tp = self._seq(R).sequenceMovingWindowReduce("v", 2, "Mean") \
                .build()
            return tp.execute(self.ROWS), tp.getFinalSchema().getColumnNames()
        seqs, names = _both(moving)
        assert [r[-1] for r in seqs[0]] == [1.0, 1.5, 2.5]
        assert "mean(2)(v)" in names
        split = _both(lambda R: self._seq(R).splitSequenceMaxLength(2)
                      .build().execute(self.ROWS))
        assert [len(s) for s in split] == [2, 1, 2]

    def test_execute_sequence_entry(self):
        seqs = _both(lambda R: R.TransformProcess.Builder(_schema(
            R, ("dev", "String"), ("t", "Integer"), ("v", "Double")))
            .doubleMathOp("v", "Multiply", 2.0).trimSequenceToLength(1)
            .build().executeSequence([[["a", 0, 1.0], ["a", 1, 2.0]]]))
        assert seqs == [[["a", 0, 2.0]]]

    def test_seq_op_without_sequence_fails(self):
        for R in (T, J):
            tp = R.TransformProcess.Builder(_schema(
                R, ("dev", "String"), ("t", "Integer"), ("v", "Double"))
            ).window(2).build()
            with pytest.raises(ValueError, match="sequence op before"):
                tp.execute(self.ROWS)
            with pytest.raises(ValueError, match="already sequential"):
                self._seq(R).convertToSequence("dev").build().execute(
                    self.ROWS)


def _join_window_pipeline(R, readings, devices):
    """test_datavec_ext's pipeline: CSV -> join -> transform ->
    convertToSequence -> window -> sequence iterator."""
    r_schema = _schema(R, ("dev", "String"), ("t", "Integer"), ("v", "Double"))
    d_schema = _schema(R, ("dev", "String"), ("label", "Integer"))
    left = list(R.CSVRecordReader().initialize(readings))
    right = list(R.CSVRecordReader().initialize(devices))
    join = (R.Join.Builder("Inner").setJoinColumns("dev")
            .setSchemas(r_schema, d_schema).build())
    joined = R.executeJoin(join, left, right)
    tp = (R.TransformProcess.Builder(join.outputSchema())
          .convertToSequence("dev", "t")
          .removeColumns("dev", "t")
          .window(4, 2)
          .build())
    windows = tp.execute(joined)
    it = R.SequenceRecordReaderDataSetIterator(
        R.CollectionSequenceRecordReader(windows), batch_size=32,
        label_index=1, num_classes=2)
    return joined, windows, tp.getFinalSchema().getColumnNames(), it


class TestEndToEndPipeline:
    def test_csv_join_window_iterator_fit(self, tmp_path):
        readings = tmp_path / "readings.csv"
        rng = np.random.RandomState(0)
        lines = []
        for dev in ("d0", "d1", "d2", "d3"):
            bias = 2.0 if dev in ("d1", "d3") else -2.0
            for t in range(8):
                lines.append(f"{dev},{t},{rng.randn() * 0.3 + bias:.4f}")
        readings.write_text("\n".join(lines) + "\n")
        devices = tmp_path / "devices.csv"
        devices.write_text("d0,0\nd1,1\nd2,0\nd3,1\n")

        tj, tw, tnames, tit = _join_window_pipeline(T, str(readings),
                                                    str(devices))
        jj, jw, jnames, jit = _join_window_pipeline(J, str(readings),
                                                    str(devices))
        _same(tj, jj)
        _same(tw, jw)
        assert len(tj) == 32 and len(tj[0]) == 4
        assert all(len(w) == 4 for w in tw)
        assert tnames == jnames == ["v", "label"]
        _same_batches(list(tit), list(jit))

        conf = (NeuralNetConfiguration.Builder().seed(1)
                .updater(tupd.Adam(1e-2)).weightInit("xavier").list()
                .layer(tlayers.LSTM(nOut=8))
                .layer(tlayers.RnnOutputLayer(nOut=2, lossFunction="mcxent"))
                .setInputType(InputType.recurrent(1, 4)).build())
        net = MultiLayerNetwork(conf).init(device="cpu")
        net.fit(tit, epochs=1)
        first = net.score()
        net.fit(tit, epochs=15)
        assert net.score() < first * 0.8, (first, net.score())


class TestReviewRegressions:
    def test_seq_mode_column_add_no_schema_duplication(self):
        def run(R):
            tp = (R.TransformProcess.Builder(_schema(R, ("s", "String")))
                  .stringLengthColumn("s", "len").build())
            return (tp.executeSequence([[["ab"], ["abc"]], [["x"]],
                                        [["yyyy"]]]),
                    tp.getFinalSchema().getColumnNames())
        seqs, names = _both(run)
        assert names == ["s", "len"] and seqs[0] == [["ab", 2], ["abc", 3]]

    def test_execute_sequence_empty_input(self):
        def run(R):
            tp = (R.TransformProcess.Builder(_schema(R, ("s", "String")))
                  .trimStringTransform("s")
                  .stringLengthColumn("s", "len").build())
            return tp.executeSequence([]), \
                tp.getFinalSchema().getColumnNames()
        seqs, names = _both(run)
        assert seqs == [] and names == ["s", "len"]

    def test_trim_zero_from_end_is_noop(self):
        seqs = _both(lambda R: R.TransformProcess.Builder(_schema(
            R, ("dev", "String"), ("t", "Integer"), ("v", "Double")))
            .convertToSequence("dev", "t")
            .trimSequence(0, from_start=False).build()
            .execute([["a", 0, 1.0], ["a", 1, 2.0]]))
        assert [len(s) for s in seqs] == [2]


# ------------------------------ test_image.py's TestTransformProcessNewOps
class TestTransformProcessNewOps:
    def test_numeric_string_time_ops(self):
        def run(R):
            schema = (R.Schema.Builder().addColumnDouble("v")
                      .addColumnString("s").addColumnString("ts").build())
            tp = (R.TransformProcess.Builder(schema)
                  .doubleMathFunction("v", "Sqrt")
                  .clipValues("v", 0.0, 2.0)
                  .addConstantColumn("k", R.ColumnType.DOUBLE, 10.0)
                  .doubleColumnsMathOp("vk", "Multiply", "v", "k")
                  .changeCase("s", "UPPER")
                  .appendStringColumnTransform("s", "!")
                  .stringToTimeTransform("ts", "%Y-%m-%d %H:%M")
                  .deriveColumnsFromTime("ts", "hourOfDay", "dayOfWeek")
                  .build())
            return tp.execute([[9.0, "abc", "2026-01-05 13:30"],
                               [16.0, "x y", "2026-01-06 07:00"]]), \
                tp.getFinalSchema().columns
        rows, cols = _both(run)
        names = [c["name"] for c in cols]
        r = dict(zip(names, rows[0]))
        assert r["v"] == 2.0 and r["vk"] == 20.0 and r["s"] == "ABC!"
        assert r["ts[hourOfDay]"] == 13          # read as UTC, not local
        assert r["ts[dayOfWeek]"] == 1            # ISO: Monday is 1
        assert r["ts"] == 1767619800000           # ms since the epoch, UTC
        assert dict(zip(names, rows[1]))["ts[dayOfWeek]"] == 2
        assert cols[2]["type"] == T.ColumnType.TIME

    def test_column_management_ops(self):
        def run(R):
            schema = (R.Schema.Builder().addColumnDouble("a")
                      .addColumnDouble("b").build())
            tp = (R.TransformProcess.Builder(schema)
                  .duplicateColumns(["a"], ["a2"])
                  .reorderColumns("b", "a")
                  .convertToInteger("b")
                  .firstDigitTransform("a", "fd")
                  .build())
            return tp.execute([[123.0, 4.5]]), \
                tp.getFinalSchema().getColumnNames()
        rows, names = _both(run)
        assert names == ["b", "a", "a2", "fd"]
        assert rows[0] == [4, 123.0, 123.0, 1]


def test_datavec_transform_process():
    """test_quick_smoke.py's case, and the readers and the rest of the
    Builder's steps through both packages."""
    def run(R):
        schema = (R.Schema.Builder().addColumnString("name")
                  .addColumnDouble("x").addColumnDouble("y").build())
        tp = R.TransformProcess.Builder(schema).removeColumns("name").build()
        rows = tp.execute([["a", 1.0, 2.0], ["b", 3.0, 4.0]])
        return rows, tp.final_schema.getColumnNames(), repr(tp.final_schema)
    rows, names, shown = _both(run)
    assert rows == [[1.0, 2.0], [3.0, 4.0]] and names == ["x", "y"]
    assert shown == "Schema(x:Double, y:Double)"


LINES = ["id,kind,x,y,when", "1,cat,1.5,-2,2026-03-01 23:59:59",
         "2,dog,2,3.25,2026-03-02 00:00:01", "", "3,cat,-0.5,1e3,"
         "2026-02-28 12:00:00", "4, Bird ,7,0,2026-03-01 06:30:00"]


@pytest.mark.parametrize("steps", [
    lambda b: b.removeAllColumnsExceptFor("x", "kind").renameColumn(
        "kind", "k").categoricalToInteger("k"),
    lambda b: b.stringToCategorical("kind", ["cat", "dog", " Bird "])
    .categoricalToOneHot("kind").integerToCategorical("id", list("abcde")),
    lambda b: b.doubleMathOp("x", "Power", 2).normalize("x")
    .normalize("y", "Standardize").conditionalReplaceValueTransform(
        "y", 0.0, lambda v: v > 100),
    lambda b: b.convertToString("x").convertToDouble("id").longMathOp(
        "id", "Add", 3).timeMathOp("id", "Multiply", 2)
    .replaceInvalidWithInteger("kind", -1),
    lambda b: b.stringMapTransform("kind", {"cat": "feline"})
    .stringRemoveWhitespaceTransform("kind").replaceStringTransform(
        "kind", {"[aeiou]": "_"}).concatenateStringColumns(
            "both", "|", "kind", "id").changeCase("both"),
    lambda b: b.stringToTimeTransform("when", "%Y-%m-%d %H:%M:%S")
    .deriveColumnsFromTime("when", "year", "monthOfYear", "dayOfMonth",
                           "minuteOfHour", "secondOfMinute")
    .doubleMathFunction("y", "Sign").custom(
        lambda rows, sch: (rows[::-1], sch)),
    lambda b: b.filter(lambda r: r["x"] > 1.8).doubleColumnsMathOp(
        "s", "Average", "x", "y").doubleColumnsMathOp("d", "Divide", "x",
                                                     "y"),
], ids=["keep-rename-cat2int", "str2cat-onehot-int2cat",
        "power-normalize-replace", "convert-math-invalid", "strings",
        "time-sign-custom", "filter-colmath"])
def test_builder_steps_through_both(steps):
    """The CSV reader (a header skipped, a blank line dropped, numbers
    typed by ``_auto_writable``) into every other Builder step."""
    def run(R):
        recs = list(R.CSVRecordReader(skip_lines=1).initialize(list(LINES)))
        schema = (R.Schema.Builder().addColumnInteger("id")
                  .addColumnCategorical("kind", "cat", "dog", " Bird ")
                  .addColumnDouble("x")
                  .addColumnDouble("y").addColumnString("when").build())
        tp = steps(R.TransformProcess.Builder(schema)).build()
        return recs, tp.execute(recs), tp.getFinalSchema().columns
    recs, rows, cols = _both(run)
    assert len(recs) == 4 and type(recs[0][0]).__name__ == "IntWritable"
    assert rows and cols


def test_line_collection_and_csv_sequence_readers(tmp_path):
    text = tmp_path / "lines.txt"
    text.write_text("alpha\nbeta gamma\n")
    for i in range(3):
        (tmp_path / f"s{i}.csv").write_text(
            "".join(f"{t * 0.5 + i},{t % 2}\n" for t in range(2 + i)))
    paths = [str(tmp_path / f"s{i}.csv") for i in range(3)]

    def run(R):
        lines = list(R.LineRecordReader().initialize(str(text)))
        listed = list(R.LineRecordReader().initialize(["x", "y"]))
        coll = list(R.CollectionRecordReader([[1, "2.5", "z"]]))
        seqs = list(R.CSVSequenceRecordReader().initialize(paths))
        batches = list(R.SequenceRecordReaderDataSetIterator(
            R.CSVSequenceRecordReader().initialize(paths), 2, -1, 2))
        return lines, listed, coll, seqs, batches
    tl, tls, tc, ts, tb = run(T)
    jl, jls, jc, js, jb = run(J)
    _same([tl, tls, tc, ts], [jl, jls, jc, js])
    _same_batches(tb, jb)
    assert [len(s) for s in ts] == [2, 3, 4]
    assert tb[0].features_mask is not None          # ragged: masked
    assert tb[0].features.shape == (2, 1, 3) and tb[1].labels.shape == \
        (1, 2, 4)


def test_record_reader_iterator_regression_and_unlabelled():
    rows = [[0.5, 1, 2.0], [1.5, 0, 3.0], [2.5, 1, 4.0]]

    def run(R):
        out = []
        for kw in ({"label_index": 1, "num_classes": 2},
                   {"label_index": -1, "regression": True},
                   {"label_index": None}):
            out.append(list(R.RecordReaderDataSetIterator(
                R.CollectionRecordReader(rows), 2, **kw)))
        return out
    for g, w in zip(run(T), run(J)):
        _same_batches(g, w)


def test_sequence_iterator_ignores_a_pre_processor():
    """The JAX sequence iterator never applies ``setPreProcessor``'s
    normalizer (records.py:1307-1336); the port pins that."""
    seqs = [[[1.0, 0], [3.0, 1]], [[5.0, 1], [7.0, 0]]]
    for R, Norm in ((T, NormalizerStandardize), (J, JNorm)):
        it = R.SequenceRecordReaderDataSetIterator(
            R.CollectionSequenceRecordReader(seqs), 2, -1, 2)
        raw = it.next()
        norm = Norm()
        norm.fit(raw)
        it.reset()
        it.setPreProcessor(norm)
        again = it.next()
        assert np.array_equal(np.asarray(again.features),
                              np.asarray(raw.features))


def test_normalize_is_float64_over_the_rows_given():
    """``normalize`` computes its statistics in float64 over the rows it
    is handed (one call, not a fitted pass), and writes numpy float64."""
    def run(R):
        tp = R.TransformProcess.Builder(_schema(R, ("x", "Double"))) \
            .normalize("x").build()
        return tp.execute([[1.0], [2.0], [4.0]]), tp.execute([[10.0], [20.0]])
    a, b = _both(run)
    assert a == [[0.0], [1 / 3], [1.0]] and b == [[0.0], [1.0]]
    assert type(a[1][0]) is np.float64


# ---------------------------------- chip_smoke phase 32, paths (a) and (b)
def _mlp(Conf, M, It, upd, n_in, width=32):
    return (Conf.Builder().seed(5).updater(upd.Adam(1e-3)).list()
            .layer(M.DenseLayer(nOut=width, activation="relu"))
            .layer(M.DenseLayer(nOut=width, activation="relu"))
            .layer(M.DenseLayer(nOut=width, activation="relu"))
            .layer(M.OutputLayer(nOut=2, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(It.feedForward(n_in)).build())


def _lstm(Conf, M, It, upd):
    return (Conf.Builder().seed(5).updater(upd.Adam(5e-3)).list()
            .layer(M.LSTM(nOut=10, activation="tanh"))
            .layer(M.RnnOutputLayer(nOut=6, activation="softmax",
                                    lossFunction="mcxent"))
            .setInputType(It.recurrent(1, fx.CHART_LENGTH)).build())


def _two_steps(jconf, tconf, batches, jbatches):
    """Two fit steps of the JAX net and of the port net from its
    parameters: losses, outputs before and params after held."""
    j = JMLN(jconf).init()
    t = MultiLayerNetwork(tconf)
    t.params_from_jax(j._params, j._states, device="cpu")
    x0 = batches[0].features
    np.testing.assert_allclose(t.output(x0).numpy(),
                               np.asarray(j.output(jbatches[0].features)),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for tb, jb in zip(batches[:2], jbatches[:2]):
        j.fit(JDataSet(jb.features, jb.labels, jb.features_mask,
                       jb.labels_mask))
        t.fit(tb)
        np.testing.assert_allclose(t.score(), float(j.score()),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    for i, p in enumerate(j._params):
        for k, v in p.items():
            np.testing.assert_allclose(
                t._params[i][k].detach().numpy(), np.asarray(v),
                rtol=FIT_TOL, atol=FIT_TOL, err_msg=f"layer {i} {k}")


def test_tabular_path_small(tmp_path):
    """Phase 32 (a) at 2,048 rows: CSV -> TransformProcess ->
    CollectionRecordReader -> RecordReaderDataSetIterator(B=256), batches
    bit-equal; two MLP steps against the JAX net's."""
    path = str(tmp_path / "transactions.csv")
    fx.write_transactions(path, 2048, seed=0)

    def run(R):
        tp = fx.transaction_process(R)
        rows = tp.execute(list(R.CSVRecordReader().initialize(path)))
        schema = tp.getFinalSchema()
        label = schema.getIndexOfColumn("FraudLabel")
        it = R.RecordReaderDataSetIterator(R.CollectionRecordReader(rows),
                                           256, label, 2)
        return rows, schema.columns, list(it)
    trows, tcols, tb = run(T)
    jrows, jcols, jb = run(J)
    _same(trows, jrows)
    _same(tcols, jcols)
    _same_batches(tb, jb)
    names = [c["name"] for c in tcols]
    assert names == ["NumItemsInTransaction", "MerchantCountryCode[USA]",
                     "MerchantCountryCode[CAN]", "MerchantCountryCode[FR]",
                     "MerchantCountryCode[MX]", "TransactionAmountUSD",
                     "FraudLabel", "DateTime[hourOfDay]"]
    n = sum(b.features.shape[0] for b in tb)
    assert 1400 < n < 1900                      # ~80% are USA or CAN
    assert all(b.features[:, 3:5].sum() == 0 for b in tb)
    _two_steps(_mlp(JConf, jlayers, JInputType, jupd, 7),
               _mlp(NeuralNetConfiguration, tlayers, InputType, tupd, 7),
               tb, jb)


def test_sequence_path_small(tmp_path):
    """Phase 32 (b) at 60 charts: CSVSequenceRecordReader ->
    SequenceRecordReaderDataSetIterator(B=10, label -1, 6 classes),
    batches bit-equal, standardized by both normalizers alike; two LSTM
    steps against the JAX net's."""
    paths = fx.write_control_charts(str(tmp_path / "charts"), seed=0,
                                    per_class=10)
    assert len(paths) == 60 and sorted(paths) == paths

    def run(R, Norm):
        it = R.SequenceRecordReaderDataSetIterator(
            R.CSVSequenceRecordReader().initialize(paths), 10, -1, 6)
        batches = list(it)
        norm = Norm()
        norm.fit(np.concatenate([np.asarray(b.features) for b in batches]))
        for b in batches:
            norm.transform(b)
        return batches
    tb, jb = run(T, NormalizerStandardize), run(J, JNorm)
    _same_batches(tb, jb)
    assert tb[0].features.shape == (10, 1, 60)
    assert tb[0].labels.shape == (10, 6, 60)
    assert tb[0].features_mask is None           # equal lengths: no mask
    labels = np.concatenate([b.labels[:, :, 0].argmax(1) for b in tb])
    assert np.bincount(labels, minlength=6).tolist() == [10] * 6
    _two_steps(_lstm(JConf, jlayers, JInputType, jupd),
               _lstm(NeuralNetConfiguration, tlayers, InputType, tupd),
               tb, jb)


def test_control_chart_classes_have_their_shapes():
    rng = np.random.RandomState(1)
    y = {c: fx.control_chart(rng, c) for c in range(6)}
    t = np.arange(fx.CHART_LENGTH)
    assert abs(np.mean(y[0]) - 30) < 2
    assert np.polyfit(t, y[2], 1)[0] > 0.1 > -0.1 > np.polyfit(t, y[3], 1)[0]
    assert y[4][-10:].mean() - y[4][:10].mean() > 5
    assert y[5][-10:].mean() - y[5][:10].mean() < -5
    assert np.std(y[1]) > np.std(y[0])


def test_fixture_files_are_seeded(tmp_path):
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    fx.write_transactions(a, 64, seed=3)
    fx.write_transactions(b, 64, seed=3)
    assert open(a).read() == open(b).read()
    assert len(open(a).read().splitlines()) == 64
    fx.write_speech_commands(str(tmp_path / "w1"), 8, seed=2)
    fx.write_speech_commands(str(tmp_path / "w2"), 8, seed=2)
    for word in fx.WORDS:
        files = os.listdir(tmp_path / "w1" / word)
        assert len(files) == 1
        assert (tmp_path / "w1" / word / files[0]).read_bytes() == \
            (tmp_path / "w2" / word / files[0]).read_bytes()
