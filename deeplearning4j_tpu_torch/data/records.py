"""DataVec: the ``Writable`` types, record readers, the schema, the
transform process, joins and reductions, and the bridges from readers to
``DataSet`` batches — ``deeplearning4j_tpu/data/records.py`` whole.

Reference parity: ``datavec/datavec-api`` —
``org.datavec.api.records.reader.RecordReader`` impls (CSV, line,
collection, sequence), the ``Writable`` type system,
``org.datavec.api.transform.{TransformProcess, schema.Schema}`` with its
transform ops (remove/rename columns, categorical→integer/one-hot,
normalize, filter, conditional replace, ...), ``Reducer`` and ``Join``.

Host code, as in the JAX package: transforms run columnar on the host
(Python lists of values) and end in ``RecordReaderDataSetIterator`` or
``SequenceRecordReaderDataSetIterator``, which emit numpy batches in the
port's ``DataSet``; a network's ``fit`` moves them to the card.

Where DataVec and the JAX package differ, this module follows the JAX
package: ``stringToTimeTransform`` takes a ``strptime`` format and reads
the time as UTC, ``deriveColumnsFromTime`` names its fields ``hourOfDay``
and so on, ``normalize`` works on float64 over the rows it is given, and
``SequenceRecordReaderDataSetIterator`` applies no pre-processor.
"""

from __future__ import annotations

import csv
import io
import math
import os
import re
from datetime import datetime, timezone
from typing import Any, Callable, Dict, Iterable, List, Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet, DataSetIterator


# ------------------------------------------------------------------ writables
class Writable:
    """Base value wrapper (ref: org.datavec.api.writable.Writable)."""

    def __init__(self, value):
        self.value = value

    def toDouble(self) -> float:
        return float(self.value)

    def toInt(self) -> int:
        return int(float(self.value))

    def toString(self) -> str:
        return str(self.value)

    def __repr__(self):
        return f"{type(self).__name__}({self.value!r})"

    def __eq__(self, other):
        return isinstance(other, Writable) and self.value == other.value


class DoubleWritable(Writable):
    pass


class IntWritable(Writable):
    pass


class Text(Writable):
    pass


class FloatWritable(Writable):
    pass


# -------------------------------------------------------------------- schema
class ColumnType:
    DOUBLE = "Double"
    INTEGER = "Integer"
    CATEGORICAL = "Categorical"
    STRING = "String"
    TIME = "Time"


class Schema:
    """Column schema (ref: org.datavec.api.transform.schema.Schema)."""

    def __init__(self, columns: List[Dict] = None):
        self.columns = columns or []

    class Builder:
        def __init__(self):
            self._cols = []

        def addColumnDouble(self, name):
            self._cols.append({"name": name, "type": ColumnType.DOUBLE})
            return self

        def addColumnsDouble(self, *names):
            for n in names:
                self.addColumnDouble(n)
            return self

        def addColumnInteger(self, name):
            self._cols.append({"name": name, "type": ColumnType.INTEGER})
            return self

        def addColumnsInteger(self, *names):
            for n in names:
                self.addColumnInteger(n)
            return self

        def addColumnCategorical(self, name, *state_names):
            self._cols.append({"name": name, "type": ColumnType.CATEGORICAL,
                               "states": list(state_names)})
            return self

        def addColumnString(self, name):
            self._cols.append({"name": name, "type": ColumnType.STRING})
            return self

        def build(self):
            return Schema(self._cols)

    def numColumns(self) -> int:
        return len(self.columns)

    def getColumnNames(self) -> List[str]:
        return [c["name"] for c in self.columns]

    def getIndexOfColumn(self, name: str) -> int:
        return self.getColumnNames().index(name)

    def getColumnTypes(self):
        return [c["type"] for c in self.columns]

    def __repr__(self):
        return "Schema(" + ", ".join(f"{c['name']}:{c['type']}"
                                     for c in self.columns) + ")"


# ----------------------------------------------------------- record readers
class RecordReader:
    """ref: org.datavec.api.records.reader.RecordReader — an iterator over
    records (lists of Writables)."""

    def hasNext(self) -> bool:
        raise NotImplementedError

    def next(self) -> List[Writable]:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()


class CSVRecordReader(RecordReader):
    """ref: org.datavec.api.records.reader.impl.csv.CSVRecordReader."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._rows = []
        self._pos = 0

    def initialize(self, source: Union[str, io.TextIOBase, List[str]]):
        if isinstance(source, str):
            with open(source) as f:
                lines = f.read().splitlines()
        elif isinstance(source, list):
            lines = source
        else:
            lines = source.read().splitlines()
        reader = csv.reader(lines[self.skip_lines:], delimiter=self.delimiter)
        self._rows = [[_auto_writable(v) for v in row] for row in reader if row]
        self._pos = 0
        return self

    def hasNext(self):
        return self._pos < len(self._rows)

    def next(self):
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def reset(self):
        self._pos = 0


class LineRecordReader(RecordReader):
    """ref: impl.LineRecordReader — one Text writable per line."""

    def __init__(self):
        self._lines = []
        self._pos = 0

    def initialize(self, source: Union[str, List[str]]):
        if isinstance(source, str) and os.path.exists(source):
            with open(source) as f:
                self._lines = f.read().splitlines()
        elif isinstance(source, list):
            self._lines = source
        else:
            self._lines = str(source).splitlines()
        self._pos = 0
        return self

    def hasNext(self):
        return self._pos < len(self._lines)

    def next(self):
        line = self._lines[self._pos]
        self._pos += 1
        return [Text(line)]

    def reset(self):
        self._pos = 0


class CollectionRecordReader(RecordReader):
    """ref: impl.collection.CollectionRecordReader."""

    def __init__(self, records: List[List]):
        self._records = [[v if isinstance(v, Writable) else _auto_writable(v)
                          for v in r] for r in records]
        self._pos = 0

    def hasNext(self):
        return self._pos < len(self._records)

    def next(self):
        r = self._records[self._pos]
        self._pos += 1
        return r

    def reset(self):
        self._pos = 0


class CSVSequenceRecordReader(RecordReader):
    """ref: impl.csv.CSVSequenceRecordReader — one CSV file per sequence."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._sequences = []
        self._pos = 0

    def initialize(self, sources: Sequence[Union[str, List[str]]]):
        self._sequences = []
        for src in sources:
            rr = CSVRecordReader(self.skip_lines, self.delimiter).initialize(src)
            self._sequences.append(list(rr))
        self._pos = 0
        return self

    def hasNext(self):
        return self._pos < len(self._sequences)

    def next(self):
        s = self._sequences[self._pos]
        self._pos += 1
        return s

    def reset(self):
        self._pos = 0


def _auto_writable(v) -> Writable:
    try:
        f = float(v)
        if f.is_integer() and "." not in str(v):
            return IntWritable(int(f))
        return DoubleWritable(f)
    except (TypeError, ValueError):
        return Text(v)


# ------------------------------------------------------------ transform DSL
class TransformProcess:
    """Columnar transform pipeline (ref:
    org.datavec.api.transform.TransformProcess). Build with the Builder,
    execute with ``execute(records)`` (the LocalTransformExecutor path)."""

    def __init__(self, initial_schema: Schema, steps: List):
        self.initial_schema = initial_schema
        self.steps = steps

    class Builder:
        def __init__(self, schema: Schema):
            self.schema = schema
            self.steps = []

        def removeColumns(self, *names):
            self.steps.append(("remove", names))
            return self

        def removeAllColumnsExceptFor(self, *names):
            self.steps.append(("keep", names))
            return self

        def renameColumn(self, old, new):
            self.steps.append(("rename", (old, new)))
            return self

        def categoricalToInteger(self, *names):
            self.steps.append(("cat2int", names))
            return self

        def categoricalToOneHot(self, *names):
            self.steps.append(("cat2onehot", names))
            return self

        def integerToCategorical(self, name, states):
            self.steps.append(("int2cat", (name, states)))
            return self

        def stringToCategorical(self, name, states):
            self.steps.append(("str2cat", (name, states)))
            return self

        def doubleMathOp(self, name, op, value):
            self.steps.append(("math", (name, op, value)))
            return self

        def normalize(self, name, kind: str = "MinMax"):
            self.steps.append(("normalize", (name, kind)))
            return self

        def filter(self, predicate: Callable[[Dict], bool]):
            """Remove rows where predicate(row_dict) is True (ref:
            ConditionFilter)."""
            self.steps.append(("filter", predicate))
            return self

        def conditionalReplaceValueTransform(self, name, new_value,
                                             predicate: Callable[[Any], bool]):
            self.steps.append(("cond_replace", (name, new_value, predicate)))
            return self

        def custom(self, fn: Callable):
            """Escape hatch: fn(rows, schema) -> (rows, schema)."""
            self.steps.append(("custom", fn))
            return self

        # -- column management (ref: transform.column.*) --
        def addConstantColumn(self, name, col_type, value):
            self.steps.append(("add_const", (name, col_type, value)))
            return self

        def duplicateColumns(self, names, new_names):
            self.steps.append(("duplicate", (tuple(names), tuple(new_names))))
            return self

        def reorderColumns(self, *names):
            self.steps.append(("reorder", names))
            return self

        def convertToString(self, name):
            self.steps.append(("convert", (name, str, ColumnType.STRING)))
            return self

        def convertToDouble(self, name):
            self.steps.append(("convert", (name, float, ColumnType.DOUBLE)))
            return self

        def convertToInteger(self, name):
            self.steps.append(("convert", (name, lambda v: int(float(v)),
                                           ColumnType.INTEGER)))
            return self

        # -- numeric (ref: transform.doubletransform.*) --
        def doubleMathFunction(self, name, fn_name):
            self.steps.append(("mathfn", (name, fn_name)))
            return self

        def doubleColumnsMathOp(self, new_name, op, *columns):
            self.steps.append(("colmath", (new_name, op, columns)))
            return self

        def integerMathOp(self, name, op, value):
            self.steps.append(("math", (name, op, value)))
            return self

        longMathOp = integerMathOp

        def clipValues(self, name, lo, hi):
            self.steps.append(("clip", (name, lo, hi)))
            return self

        def replaceInvalidWithInteger(self, name, value):
            self.steps.append(("replace_invalid", (name, value)))
            return self

        # -- strings (ref: transform.string.*) --
        def appendStringColumnTransform(self, name, suffix):
            self.steps.append(("append_str", (name, suffix)))
            return self

        def changeCase(self, name, case: str = "LOWER"):
            self.steps.append(("change_case", (name, case)))
            return self

        def stringMapTransform(self, name, mapping: Dict[str, str]):
            self.steps.append(("str_map", (name, dict(mapping))))
            return self

        def stringRemoveWhitespaceTransform(self, name):
            self.steps.append(("rm_ws", (name,)))
            return self

        def replaceStringTransform(self, name, regex_map: Dict[str, str]):
            self.steps.append(("str_regex", (name, dict(regex_map))))
            return self

        def concatenateStringColumns(self, new_name, delimiter, *columns):
            self.steps.append(("concat_str", (new_name, delimiter, columns)))
            return self

        # -- time (ref: transform.time.*) --
        def stringToTimeTransform(self, name, fmt: str):
            self.steps.append(("str2time", (name, fmt)))
            return self

        def timeMathOp(self, name, op, amount_ms: int):
            self.steps.append(("math", (name, op, amount_ms)))
            return self

        def deriveColumnsFromTime(self, name, *fields):
            """fields from: hourOfDay, dayOfWeek, dayOfMonth, monthOfYear,
            year, minuteOfHour, secondOfMinute."""
            self.steps.append(("derive_time", (name, fields)))
            return self

        def firstDigitTransform(self, name, new_name):
            self.steps.append(("first_digit", (name, new_name)))
            return self

        # -- r4 numeric additions (ref: transform.doubletransform.*) --
        def absValueColumn(self, name):
            self.steps.append(("mathfn", (name, "Abs")))
            return self

        def roundDoubleColumn(self, name, decimals: int = 0):
            self.steps.append(("round_double", (name, decimals)))
            return self

        def subtractMean(self, name):
            self.steps.append(("subtract_mean", (name,)))
            return self

        def replaceEmptyWithValue(self, name, value):
            self.steps.append(("replace_empty", (name, value)))
            return self

        # -- r4 string additions (ref: transform.string.*) --
        def stringLengthColumn(self, name, new_name):
            self.steps.append(("str_len", (name, new_name)))
            return self

        def trimStringTransform(self, name):
            self.steps.append(("str_trim", (name,)))
            return self

        def padStringTransform(self, name, length: int, pad_char: str = " ",
                               side: str = "LEFT"):
            self.steps.append(("str_pad", (name, length, pad_char, side)))
            return self

        def substringTransform(self, name, frm: int, to: int = None):
            self.steps.append(("str_sub", (name, frm, to)))
            return self

        def mapAllStringsExceptList(self, name, new_value, keep):
            self.steps.append(("str_map_except", (name, new_value,
                                                  tuple(keep))))
            return self

        # -- r4 categorical additions --
        def oneHotToCategorical(self, new_name, *onehot_columns):
            self.steps.append(("onehot2cat", (new_name,
                                              tuple(onehot_columns))))
            return self

        # -- r4 filters / conditional copies --
        def filterInvalidValues(self, *names):
            """Drop rows whose named columns fail float conversion or are
            NaN (ref: FilterInvalidValues)."""
            self.steps.append(("filter_invalid", names))
            return self

        def conditionalCopyValueTransform(self, col_to_change, col_to_copy,
                                          predicate):
            self.steps.append(("cond_copy", (col_to_change, col_to_copy,
                                             predicate)))
            return self

        # -- r4 aggregation (ref: transform.reduce.Reducer) --
        def reduce(self, reducer: "Reducer"):
            self.steps.append(("reduce", reducer))
            return self

        # -- sequence ops (ref: transform.sequence.*; VERDICT r3 #6) --
        def convertToSequence(self, key_columns, sort_column=None):
            """Group rows by key column(s) into sequences, sorted within
            each sequence by ``sort_column`` (ref: convertToSequence +
            comparator)."""
            keys = ([key_columns] if isinstance(key_columns, str)
                    else list(key_columns))
            self.steps.append(("to_sequence", (keys, sort_column)))
            return self

        def convertFromSequence(self):
            self.steps.append(("from_sequence", ()))
            return self

        def window(self, size: int, step: int = None):
            """Sliding windows over each sequence; each window becomes its
            own sequence (ref: sequence window functions)."""
            self.steps.append(("seq_window", (size, step or size)))
            return self

        def padSequenceToLength(self, length: int, pad_value=0):
            self.steps.append(("seq_pad", (length, pad_value)))
            return self

        def trimSequence(self, num_steps: int, from_start: bool = True):
            """Remove ``num_steps`` steps from the start (or end) of each
            sequence (ref: SequenceTrimTransform)."""
            self.steps.append(("seq_trim", (num_steps, from_start)))
            return self

        def trimSequenceToLength(self, length: int):
            self.steps.append(("seq_trim_len", (length,)))
            return self

        def offsetSequence(self, columns, offset: int, pad_value=0):
            """Shift the named columns by ``offset`` steps WITHIN each
            sequence (ref: SequenceOffsetTransform; e.g. next-step labels
            with offset=-1)."""
            cols = [columns] if isinstance(columns, str) else list(columns)
            self.steps.append(("seq_offset", (cols, offset, pad_value)))
            return self

        def reverseSequence(self):
            self.steps.append(("seq_reverse", ()))
            return self

        def sequenceDifference(self, name):
            """Replace the column with step-to-step differences (first
            step becomes 0; ref: SequenceDifferenceTransform)."""
            self.steps.append(("seq_diff", (name,)))
            return self

        def sequenceMovingWindowReduce(self, name, window: int,
                                      op: str = "Mean"):
            """New column = reduction over the trailing window of the named
            column (ref: SequenceMovingWindowReduceTransform)."""
            self.steps.append(("seq_moving", (name, window, op)))
            return self

        def splitSequenceMaxLength(self, max_length: int):
            self.steps.append(("seq_split_max", (max_length,)))
            return self

        def build(self):
            return TransformProcess(self.schema, self.steps)

    # -- execution (ref: LocalTransformExecutor.execute) --
    _SEQ_OPS = {"seq_window", "seq_pad", "seq_trim", "seq_trim_len",
                "seq_offset", "seq_reverse", "seq_diff", "seq_moving",
                "seq_split_max"}

    def execute(self, records: Iterable[List]) -> List[List]:
        rows = [[w.value if isinstance(w, Writable) else w for w in r]
                for r in records]
        rows, schema = self._run(rows, False)
        return rows

    def executeSequence(self, sequences: Iterable[List[List]]) -> List:
        """Sequence-mode execution (ref: LocalTransformExecutor
        .executeSequence): input is a list of sequences of rows."""
        seqs = [[[w.value if isinstance(w, Writable) else w for w in r]
                 for r in seq] for seq in sequences]
        seqs, schema = self._run(seqs, True)
        return seqs

    def _run(self, rows, seq_mode: bool):
        schema = Schema([dict(c) for c in self.initial_schema.columns])
        for kind, arg in self.steps:
            if kind == "to_sequence":
                if seq_mode:
                    raise ValueError("convertToSequence: already sequential")
                rows, schema = self._to_sequence(arg, rows, schema)
                seq_mode = True
            elif kind == "from_sequence":
                rows = [r for seq in rows for r in seq]
                seq_mode = False
            elif kind in self._SEQ_OPS:
                if not seq_mode:
                    raise ValueError(f"{kind}: sequence op before "
                                     f"convertToSequence / executeSequence")
                rows, schema = self._apply_seq(kind, arg, rows, schema)
            elif seq_mode:
                # columnar ops map over each sequence's rows (row filters
                # apply within each sequence). Each application gets a
                # FRESH schema copy — _apply mutates schema in place, and
                # running it once per sequence must not append the same
                # new column repeatedly. The first sequence's resulting
                # schema becomes the pipeline schema.
                new_seqs = []
                schema_out = schema
                for i, seq in enumerate(rows):
                    fresh = Schema([dict(c) for c in schema.columns])
                    out, s2 = self._apply(kind, arg, seq, fresh)
                    if i == 0:
                        schema_out = s2
                    new_seqs.append(out)
                if not rows:   # empty input still advances the schema
                    _, schema_out = self._apply(
                        kind, arg, [], Schema([dict(c)
                                               for c in schema.columns]))
                rows, schema = new_seqs, schema_out
            else:
                rows, schema = self._apply(kind, arg, rows, schema)
        self.final_schema = schema
        return rows, schema

    def _to_sequence(self, arg, rows, schema):
        keys, sort_col = arg
        names = schema.getColumnNames()
        kidx = [names.index(k) for k in keys]
        sidx = names.index(sort_col) if sort_col is not None else None
        groups = {}
        for r in rows:
            groups.setdefault(tuple(r[i] for i in kidx), []).append(r)
        seqs = []
        for k in sorted(groups, key=lambda t: tuple(str(v) for v in t)):
            seq = groups[k]
            if sidx is not None:
                seq = sorted(seq, key=lambda r: r[sidx])
            seqs.append(seq)
        return seqs, schema

    def _apply_seq(self, kind, arg, seqs, schema):
        names = schema.getColumnNames()
        if kind == "seq_window":
            size, step = arg
            out = []
            for seq in seqs:
                for start in range(0, max(len(seq) - size, 0) + 1, step):
                    out.append([list(r) for r in seq[start:start + size]])
            return out, schema
        if kind == "seq_pad":
            length, pad = arg
            out = []
            for seq in seqs:
                seq = [list(r) for r in seq[:length]]
                while len(seq) < length:
                    seq.append([pad] * len(names))
                out.append(seq)
            return out, schema
        if kind == "seq_trim":
            n, from_start = arg
            if n == 0:
                return seqs, schema
            return ([seq[n:] if from_start else seq[:-n] for seq in seqs],
                    schema)
        if kind == "seq_trim_len":
            (length,) = arg
            return [seq[:length] for seq in seqs], schema
        if kind == "seq_offset":
            cols, offset, pad = arg
            idxs = [names.index(c) for c in cols]
            out = []
            for seq in seqs:
                seq = [list(r) for r in seq]
                vals = [[r[i] for i in idxs] for r in seq]
                T = len(seq)
                for t, r in enumerate(seq):
                    src = t - offset
                    for j, i in enumerate(idxs):
                        r[i] = vals[src][j] if 0 <= src < T else pad
                out.append(seq)
            return out, schema
        if kind == "seq_reverse":
            return [list(reversed(seq)) for seq in seqs], schema
        if kind == "seq_diff":
            (name,) = arg
            i = names.index(name)
            out = []
            for seq in seqs:
                seq = [list(r) for r in seq]
                prev = None
                for r in seq:
                    cur = float(r[i])
                    r[i] = cur - prev if prev is not None else 0.0
                    prev = cur
                out.append(seq)
            return out, schema
        if kind == "seq_moving":
            name, window, op = arg
            i = names.index(name)
            red = {"Mean": lambda vs: sum(vs) / len(vs), "Sum": sum,
                   "Min": min, "Max": max}[op]
            out = []
            for seq in seqs:
                seq = [list(r) for r in seq]
                vals = [float(r[i]) for r in seq]
                for t, r in enumerate(seq):
                    r.append(red(vals[max(0, t - window + 1):t + 1]))
                out.append(seq)
            return out, Schema(schema.columns + [
                {"name": f"{op.lower()}({window})({name})",
                 "type": ColumnType.DOUBLE}])
        if kind == "seq_split_max":
            (n,) = arg
            out = []
            for seq in seqs:
                for start in range(0, len(seq), n):
                    out.append(seq[start:start + n])
            return out, schema
        raise ValueError(kind)

    def getFinalSchema(self) -> Schema:
        if not hasattr(self, "final_schema"):
            # dry-run on empty data to compute the schema
            self.execute([])
        return self.final_schema

    def _apply(self, kind, arg, rows, schema: Schema):
        names = schema.getColumnNames()
        if kind == "remove":
            idxs = [names.index(n) for n in arg]
            keep = [i for i in range(len(names)) if i not in idxs]
            return ([[r[i] for i in keep] for r in rows],
                    Schema([schema.columns[i] for i in keep]))
        if kind == "keep":
            idxs = [names.index(n) for n in arg]
            return ([[r[i] for i in idxs] for r in rows],
                    Schema([schema.columns[i] for i in idxs]))
        if kind == "rename":
            old, new = arg
            cols = [dict(c) for c in schema.columns]
            cols[names.index(old)]["name"] = new
            return rows, Schema(cols)
        if kind == "cat2int":
            for n in arg:
                i = names.index(n)
                states = schema.columns[i].get("states")
                if states is None:
                    states = sorted({r[i] for r in rows})
                lut = {s: j for j, s in enumerate(states)}
                for r in rows:
                    r[i] = lut[r[i]]
                schema.columns[i] = {"name": n, "type": ColumnType.INTEGER}
            return rows, schema
        if kind == "cat2onehot":
            for n in arg:
                i = schema.getColumnNames().index(n)
                states = schema.columns[i].get("states")
                if states is None:
                    states = sorted({r[i] for r in rows})
                new_cols = [{"name": f"{n}[{s}]", "type": ColumnType.INTEGER}
                            for s in states]
                for r in rows:
                    onehot = [1 if r[i] == s else 0 for s in states]
                    r[i:i + 1] = onehot
                schema.columns[i:i + 1] = new_cols
            return rows, schema
        if kind == "int2cat" or kind == "str2cat":
            name, states = arg
            i = names.index(name)
            if kind == "int2cat":
                for r in rows:
                    r[i] = states[int(r[i])]
            schema.columns[i] = {"name": name, "type": ColumnType.CATEGORICAL,
                                 "states": list(states)}
            return rows, schema
        if kind == "math":
            name, op, value = arg
            i = names.index(name)
            fn = {"Add": lambda x: x + value, "Subtract": lambda x: x - value,
                  "Multiply": lambda x: x * value, "Divide": lambda x: x / value,
                  "Power": lambda x: x ** value}[op]
            for r in rows:
                r[i] = fn(float(r[i]))
            return rows, schema
        if kind == "normalize":
            name, how = arg
            i = names.index(name)
            vals = np.asarray([float(r[i]) for r in rows]) if rows else np.zeros(0)
            if how == "MinMax":
                lo, hi = (vals.min(), vals.max()) if len(vals) else (0, 1)
                rng = max(hi - lo, 1e-12)
                for r in rows:
                    r[i] = (float(r[i]) - lo) / rng
            elif how == "Standardize":
                m, s = (vals.mean(), max(vals.std(), 1e-12)) if len(vals) else (0, 1)
                for r in rows:
                    r[i] = (float(r[i]) - m) / s
            return rows, schema
        if kind == "filter":
            pred = arg
            names_now = schema.getColumnNames()
            rows = [r for r in rows
                    if not pred(dict(zip(names_now, r)))]
            return rows, schema
        if kind == "cond_replace":
            name, new_value, pred = arg
            i = names.index(name)
            for r in rows:
                if pred(r[i]):
                    r[i] = new_value
            return rows, schema
        if kind == "custom":
            return arg(rows, schema)
        if kind == "add_const":
            name, col_type, value = arg
            for r in rows:
                r.append(value)
            schema.columns.append({"name": name, "type": col_type})
            return rows, schema
        if kind == "duplicate":
            src, dst = arg
            idxs = [names.index(n) for n in src]
            for r in rows:
                r.extend(r[i] for i in idxs)
            for n, i in zip(dst, idxs):
                schema.columns.append({**schema.columns[i], "name": n})
            return rows, schema
        if kind == "reorder":
            idxs = [names.index(n) for n in arg]
            idxs += [i for i in range(len(names)) if i not in idxs]
            return ([[r[i] for i in idxs] for r in rows],
                    Schema([schema.columns[i] for i in idxs]))
        if kind == "convert":
            name, caster, col_type = arg
            i = names.index(name)
            for r in rows:
                r[i] = caster(r[i])
            schema.columns[i] = {"name": name, "type": col_type}
            return rows, schema
        if kind == "mathfn":
            name, fn_name = arg
            i = names.index(name)
            fn = {"Log": math.log, "Log2": lambda v: math.log2(v),
                  "Log10": math.log10, "Sqrt": math.sqrt, "Abs": abs,
                  "Exp": math.exp, "Sin": math.sin, "Cos": math.cos,
                  "Tan": math.tan, "Floor": math.floor, "Ceil": math.ceil,
                  "Sign": lambda v: (v > 0) - (v < 0)}[fn_name]
            for r in rows:
                r[i] = float(fn(float(r[i])))
            return rows, schema
        if kind == "colmath":
            new_name, op, cols = arg
            idxs = [names.index(n) for n in cols]
            red = {"Add": lambda vs: sum(vs),
                   "Subtract": lambda vs: vs[0] - sum(vs[1:]),
                   "Multiply": lambda vs: float(np.prod(vs)),
                   "Divide": lambda vs: vs[0] / vs[1],
                   "Max": max, "Min": min,
                   "Average": lambda vs: sum(vs) / len(vs)}[op]
            for r in rows:
                r.append(float(red([float(r[i]) for i in idxs])))
            schema.columns.append({"name": new_name, "type": ColumnType.DOUBLE})
            return rows, schema
        if kind == "clip":
            name, lo, hi = arg
            i = names.index(name)
            for r in rows:
                v = float(r[i])
                r[i] = min(max(v, lo), hi)
            return rows, schema
        if kind == "replace_invalid":
            name, value = arg
            i = names.index(name)
            for r in rows:
                try:
                    float(r[i])
                except (TypeError, ValueError):
                    r[i] = value
            return rows, schema
        if kind == "append_str":
            name, suffix = arg
            i = names.index(name)
            for r in rows:
                r[i] = str(r[i]) + suffix
            return rows, schema
        if kind == "change_case":
            name, case = arg
            i = names.index(name)
            for r in rows:
                r[i] = str(r[i]).upper() if case.upper() == "UPPER" \
                    else str(r[i]).lower()
            return rows, schema
        if kind == "str_map":
            name, mapping = arg
            i = names.index(name)
            for r in rows:
                r[i] = mapping.get(str(r[i]), r[i])
            return rows, schema
        if kind == "rm_ws":
            (name,) = arg
            i = names.index(name)
            for r in rows:
                r[i] = "".join(str(r[i]).split())
            return rows, schema
        if kind == "str_regex":
            name, regex_map = arg
            i = names.index(name)
            for r in rows:
                v = str(r[i])
                for pat, rep in regex_map.items():
                    v = re.sub(pat, rep, v)
                r[i] = v
            return rows, schema
        if kind == "concat_str":
            new_name, delim, cols = arg
            idxs = [names.index(n) for n in cols]
            for r in rows:
                r.append(delim.join(str(r[i]) for i in idxs))
            schema.columns.append({"name": new_name, "type": ColumnType.STRING})
            return rows, schema
        if kind == "str2time":
            name, fmt = arg
            i = names.index(name)
            for r in rows:
                dt = datetime.strptime(str(r[i]), fmt)
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=timezone.utc)
                r[i] = int(dt.timestamp() * 1000)
            schema.columns[i] = {"name": name, "type": ColumnType.TIME}
            return rows, schema
        if kind == "derive_time":
            name, fields = arg
            i = names.index(name)
            getters = {"hourOfDay": lambda d: d.hour,
                       "minuteOfHour": lambda d: d.minute,
                       "secondOfMinute": lambda d: d.second,
                       "dayOfWeek": lambda d: d.isoweekday(),
                       "dayOfMonth": lambda d: d.day,
                       "monthOfYear": lambda d: d.month,
                       "year": lambda d: d.year}
            for r in rows:
                d = datetime.fromtimestamp(int(r[i]) / 1000.0, tz=timezone.utc)
                r.extend(getters[f](d) for f in fields)
            for f in fields:
                schema.columns.append({"name": f"{name}[{f}]",
                                       "type": ColumnType.INTEGER})
            return rows, schema
        if kind == "first_digit":
            name, new_name = arg
            i = names.index(name)
            for r in rows:
                s = str(abs(float(r[i]))).lstrip("0.")
                r.append(int(s[0]) if s and s[0].isdigit() else 0)
            schema.columns.append({"name": new_name, "type": ColumnType.INTEGER})
            return rows, schema
        if kind == "round_double":
            name, decimals = arg
            i = names.index(name)
            for r in rows:
                r[i] = round(float(r[i]), decimals)
            return rows, schema
        if kind == "subtract_mean":
            (name,) = arg
            i = names.index(name)
            m = (sum(float(r[i]) for r in rows) / len(rows)) if rows else 0.0
            for r in rows:
                r[i] = float(r[i]) - m
            return rows, schema
        if kind == "replace_empty":
            name, value = arg
            i = names.index(name)
            for r in rows:
                if r[i] is None or str(r[i]).strip() == "":
                    r[i] = value
            return rows, schema
        if kind == "str_len":
            name, new_name = arg
            i = names.index(name)
            for r in rows:
                r.append(len(str(r[i])))
            schema.columns.append({"name": new_name,
                                   "type": ColumnType.INTEGER})
            return rows, schema
        if kind == "str_trim":
            (name,) = arg
            i = names.index(name)
            for r in rows:
                r[i] = str(r[i]).strip()
            return rows, schema
        if kind == "str_pad":
            name, length, ch, side = arg
            i = names.index(name)
            for r in rows:
                v = str(r[i])
                r[i] = (v.rjust(length, ch) if side.upper() == "LEFT"
                        else v.ljust(length, ch))
            return rows, schema
        if kind == "str_sub":
            name, frm, to = arg
            i = names.index(name)
            for r in rows:
                r[i] = str(r[i])[frm:to]
            return rows, schema
        if kind == "str_map_except":
            name, new_value, keep = arg
            i = names.index(name)
            keep = set(keep)
            for r in rows:
                if str(r[i]) not in keep:
                    r[i] = new_value
            return rows, schema
        if kind == "onehot2cat":
            new_name, cols = arg
            idxs = [names.index(c) for c in cols]
            # state name = the text inside "col[state]" when present
            states = [c[c.index("[") + 1:-1] if "[" in c else c for c in cols]
            first = min(idxs)
            for r in rows:
                hot = [j for j, i in enumerate(idxs) if float(r[i]) > 0.5]
                val = states[hot[0]] if hot else states[0]
                for i in sorted(idxs, reverse=True):
                    del r[i]
                r.insert(first, val)
            keep_cols = [c for j, c in enumerate(schema.columns)
                         if j not in idxs]
            keep_cols.insert(first, {"name": new_name,
                                     "type": ColumnType.CATEGORICAL,
                                     "states": states})
            return rows, Schema(keep_cols)
        if kind == "filter_invalid":
            idxs = [names.index(n) for n in arg]

            def bad(r):
                for i in idxs:
                    try:
                        v = float(r[i])
                    except (TypeError, ValueError):
                        return True
                    if v != v:  # NaN
                        return True
                return False
            return [r for r in rows if not bad(r)], schema
        if kind == "cond_copy":
            dst, src, pred = arg
            di, si = names.index(dst), names.index(src)
            for r in rows:
                if pred(r[di]):
                    r[di] = r[si]
            return rows, schema
        if kind == "reduce":
            return arg.reduce(rows, schema)
        raise ValueError(kind)


class RecordReaderDataSetIterator(DataSetIterator):
    """Bridge RecordReader → DataSet batches
    (ref: org.deeplearning4j.datasets.datavec.RecordReaderDataSetIterator)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: int = None,
                 regression: bool = False):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.reset()

    def reset(self):
        self.reader.reset()

    def hasNext(self):
        return self.reader.hasNext()

    def next(self) -> DataSet:
        feats, labels = [], []
        n = 0
        while self.reader.hasNext() and n < self.batch_size:
            rec = [w.value if isinstance(w, Writable) else w
                   for w in self.reader.next()]
            if self.label_index is None:
                feats.append([float(v) for v in rec])
            else:
                li = self.label_index if self.label_index >= 0 \
                    else len(rec) + self.label_index
                lab = rec[li]
                row = [float(v) for j, v in enumerate(rec) if j != li]
                feats.append(row)
                labels.append(lab)
            n += 1
        features = np.asarray(feats, np.float32)
        if self.label_index is None:
            return self._apply_pre(DataSet(features, None))
        if self.regression:
            y = np.asarray(labels, np.float32).reshape(-1, 1)
        else:
            y = np.eye(self.num_classes, dtype=np.float32)[
                np.asarray(labels, np.int64)]
        return self._apply_pre(DataSet(features, y))

    def batch(self):
        return self.batch_size


# --------------------------------------------------------------- aggregation
class Reducer:
    """Group-by aggregation (ref: org.datavec.api.transform.reduce.Reducer):
    key columns plus per-column reduction ops; one output row per key,
    reduced columns named ``op(column)`` like the reference."""

    _OPS = {
        "Sum": lambda vs: float(sum(vs)),
        "Mean": lambda vs: float(sum(vs) / len(vs)),
        "Min": lambda vs: float(min(vs)),
        "Max": lambda vs: float(max(vs)),
        "Stdev": lambda vs: float(np.std(np.asarray(vs), ddof=1))
        if len(vs) > 1 else 0.0,
        "Count": len,
        "CountUnique": lambda vs: len(set(vs)),
        "First": lambda vs: vs[0],
        "Last": lambda vs: vs[-1],
    }

    def __init__(self, key_columns, column_ops):
        self.key_columns = list(key_columns)
        self.column_ops = column_ops          # [(column, op), ...]

    class Builder:
        def __init__(self, *key_columns):
            self._keys = list(key_columns)
            self._ops = []

        def _add(self, op, names):
            self._ops.extend((n, op) for n in names)
            return self

        def sumColumns(self, *names): return self._add("Sum", names)
        def meanColumns(self, *names): return self._add("Mean", names)
        def minColumns(self, *names): return self._add("Min", names)
        def maxColumns(self, *names): return self._add("Max", names)
        def stdevColumns(self, *names): return self._add("Stdev", names)
        def countColumns(self, *names): return self._add("Count", names)
        def countUniqueColumns(self, *names):
            return self._add("CountUnique", names)
        def firstColumns(self, *names): return self._add("First", names)
        def lastColumns(self, *names): return self._add("Last", names)

        def build(self):
            return Reducer(self._keys, self._ops)

    def reduce(self, rows, schema: Schema):
        names = schema.getColumnNames()
        kidx = [names.index(k) for k in self.key_columns]
        groups = {}
        order = []
        for r in rows:
            k = tuple(r[i] for i in kidx)
            if k not in groups:
                order.append(k)
            groups.setdefault(k, []).append(r)
        out = []
        for k in order:
            grp = groups[k]
            row = list(k)
            for col, op in self.column_ops:
                i = names.index(col)
                vals = [g[i] for g in grp]
                if op not in ("First", "Last", "Count", "CountUnique"):
                    vals = [float(v) for v in vals]
                row.append(self._OPS[op](vals))
            out.append(row)
        cols = [dict(schema.columns[i]) for i in kidx]
        for col, op in self.column_ops:
            ct = (ColumnType.INTEGER if op in ("Count", "CountUnique")
                  else ColumnType.DOUBLE if op not in ("First", "Last")
                  else schema.columns[names.index(col)]["type"])
            cols.append({"name": f"{op.lower()}({col})", "type": ct})
        return out, Schema(cols)


# --------------------------------------------------------------------- joins
class Join:
    """ref: org.datavec.api.transform.join.Join — Inner/LeftOuter/
    RightOuter/FullOuter on key columns. Execute with ``executeJoin``."""

    def __init__(self, join_type, join_columns, left_schema, right_schema):
        self.join_type = join_type
        self.join_columns = list(join_columns)
        self.left_schema = left_schema
        self.right_schema = right_schema

    class Builder:
        def __init__(self, join_type: str = "Inner"):
            if join_type not in ("Inner", "LeftOuter", "RightOuter",
                                 "FullOuter"):
                raise ValueError(f"unknown join type '{join_type}'")
            self._type = join_type
            self._cols = []
            self._left = self._right = None

        def setJoinColumns(self, *names):
            self._cols = list(names)
            return self

        def setSchemas(self, left: Schema, right: Schema):
            self._left, self._right = left, right
            return self

        def build(self):
            return Join(self._type, self._cols, self._left, self._right)

    def outputSchema(self) -> Schema:
        keep_right = [c for c in self.right_schema.columns
                      if c["name"] not in self.join_columns]
        return Schema([dict(c) for c in self.left_schema.columns]
                      + [dict(c) for c in keep_right])


def executeJoin(join: Join, left_rows, right_rows):
    """ref: LocalTransformExecutor.executeJoin — hash join on the key
    columns; missing sides null-fill (None) for the outer types."""
    lnames = join.left_schema.getColumnNames()
    rnames = join.right_schema.getColumnNames()
    lk = [lnames.index(c) for c in join.join_columns]
    rk = [rnames.index(c) for c in join.join_columns]
    r_rest = [i for i in range(len(rnames)) if i not in rk]
    l_width = len(lnames)

    def _vals(rows):
        return [[w.value if isinstance(w, Writable) else w for w in r]
                for r in rows]
    left_rows, right_rows = _vals(left_rows), _vals(right_rows)

    rindex = {}
    for r in right_rows:
        rindex.setdefault(tuple(r[i] for i in rk), []).append(r)
    out = []
    matched_right = set()
    for l in left_rows:
        k = tuple(l[i] for i in lk)
        matches = rindex.get(k, [])
        if matches:
            matched_right.add(k)
            for r in matches:
                out.append(list(l) + [r[i] for i in r_rest])
        elif join.join_type in ("LeftOuter", "FullOuter"):
            out.append(list(l) + [None] * len(r_rest))
    if join.join_type in ("RightOuter", "FullOuter"):
        for k, rs in rindex.items():
            if k in matched_right:
                continue
            for r in rs:
                row = [None] * l_width
                for li, ri in zip(lk, rk):
                    row[li] = r[ri]
                out.append(row + [r[i] for i in r_rest])
    return out


class CollectionSequenceRecordReader(RecordReader):
    """ref: impl.collection.CollectionSequenceRecordReader — iterate
    in-memory sequences (lists of rows)."""

    def __init__(self, sequences):
        self._sequences = [[list(r) for r in seq] for seq in sequences]
        self._pos = 0

    def hasNext(self):
        return self._pos < len(self._sequences)

    def next(self):
        s = self._sequences[self._pos]
        self._pos += 1
        return s

    def reset(self):
        self._pos = 0


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence reader → [N, C, T] DataSet batches (ref:
    org.deeplearning4j.datasets.datavec
    .SequenceRecordReaderDataSetIterator, single-reader mode: the label
    column is part of each timestep row)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: int = None,
                 regression: bool = False):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression

    def reset(self):
        self.reader.reset()

    def hasNext(self):
        return self.reader.hasNext()

    def next(self) -> DataSet:
        seqs = []
        while self.reader.hasNext() and len(seqs) < self.batch_size:
            seq = [[w.value if isinstance(w, Writable) else w for w in r]
                   for r in self.reader.next()]
            seqs.append(seq)
        T = max(len(s) for s in seqs)
        n_cols = len(seqs[0][0])
        li = self.label_index if self.label_index >= 0 \
            else n_cols + self.label_index
        f_idx = [i for i in range(n_cols) if i != li]
        N = len(seqs)
        feats = np.zeros((N, len(f_idx), T), np.float32)
        mask = np.zeros((N, T), np.float32)
        if self.regression:
            labels = np.zeros((N, 1, T), np.float32)
        else:
            labels = np.zeros((N, self.num_classes, T), np.float32)
        for n, seq in enumerate(seqs):
            for t, row in enumerate(seq):
                for j, i in enumerate(f_idx):
                    feats[n, j, t] = float(row[i])
                if self.regression:
                    labels[n, 0, t] = float(row[li])
                else:
                    labels[n, int(float(row[li])), t] = 1.0
                mask[n, t] = 1.0
        full = bool(mask.all())
        return DataSet(feats, labels,
                       None if full else mask, None if full else mask)
