"""DataVec's value and reader base (the slice of
``deeplearning4j_tpu/data/records.py`` the image readers need): the
``Writable`` types and the ``RecordReader`` contract.

ref: ``org.datavec.api.writable.*``,
``org.datavec.api.records.reader.RecordReader``. The rest of DataVec (the
schema, ``TransformProcess``, the CSV and sequence readers, joins) is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import List


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
