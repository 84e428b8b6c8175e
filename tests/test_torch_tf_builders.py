"""The port's TF op builders (``modelimport/tensorflow.py`` ``_BUILDERS``)
against the JAX importer's builders on the same params and inputs (CPU).

The 130 stored graphs reach most builders; this table holds the ones and
the attribute corners they do not reach (SAME padding with strides and
dilation, exclusive reversed scans, negative strides, batch_dims,
out-of-range one-hot indices, empty segments, downsampling resize, the
special functions), each builder called directly, at ``rtol=1e-4,
atol=1e-5`` (the TF corpus tolerance; integer outputs equal).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("tensorflow")     # the JAX importer imports TF/ml_dtypes

from deeplearning4j_tpu.modelimport import tensorflow as jtf  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import tensorflow as ttf  # noqa: E402

rng = np.random.RandomState(7)


def f32(*shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def i32(*vals):
    return np.asarray(vals, np.int32)


SAME4 = dict(strides=[1, 2, 2, 1], padding="SAME")
CASES = [
    ("Betainc", {}, [f32(6, lo=0.5, hi=5), f32(6, lo=0.5, hi=5),
                     f32(6, lo=0.01, hi=0.99)]),
    ("Select", {}, [np.asarray([True, False, True]), f32(3, 2), f32(3, 2)]),
    ("Mod", {}, [f32(5) * 5, f32(5) + 3]),
    ("Mod", {}, [i32(-7, 7, -8, 9), i32(3, -3, 5, -4)]),
    ("FloorMod", {}, [i32(-7, 7, -8, 9), i32(3, -3, 5, -4)]),
    ("FloorDiv", {}, [i32(-7, 7, -8, 9), i32(3, -3, 5, -4)]),
    ("Relu6", {}, [f32(10) * 5]),
    ("Softplus", {}, [np.asarray([-50, -1, 0, 1, 30, 90], np.float32)]),
    ("Round", {}, [np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)]),
    ("LinSpace", {"num": 7}, [np.float32(-1.0), np.float32(2.0)]),
    ("MatrixDiag", {}, [f32(2, 3)]),
    ("MatrixBandPart", {"num_lower": 1, "num_upper": -1}, [f32(2, 4, 4)]),
    ("GatherV2", {"axis": 1, "batch_dims": 1}, [f32(2, 4, 3),
                                                 i32([0, 3, 1], [2, 2, 0])]),
    ("GatherV2", {"axis": 1}, [f32(3, 5), i32([4, 0], [1, 1])]),
    ("MirrorPad", {"paddings": [[1, 2], [2, 1]], "mode": "SYMMETRIC"},
     [f32(3, 4)]),
    ("MirrorPad", {"paddings": [[2, 0], [1, 2]], "mode": "REFLECT"},
     [f32(4, 4)]),
    ("PadV2", {"paddings": [[1, 0], [0, 2]]}, [f32(2, 3), np.float32(-4.0)]),
    ("Cumprod", {"axis": 1, "exclusive": True, "reverse": True}, [f32(2, 5)]),
    ("Cumsum", {"axis": 0, "exclusive": True, "reverse": False}, [f32(4, 2)]),
    ("Cumsum", {"axis": 1, "exclusive": False, "reverse": True},
     [i32([1, 2, 3], [4, 5, 6])]),
    ("StridedSlice", {"index": [[None, None, -1], [1, None, 2]]},
     [f32(4, 5)]),
    ("StridedSlice", {"index": ["...", "new", [3, 0, -2]]}, [f32(2, 5)]),
    ("OneHot", {"depth": 4, "on_value": 2.0, "off_value": -1.0, "axis": 0},
     [i32(0, 3, 5, -1)]),
    ("TopKV2", {"k": 3}, [f32(2, 6)]),
    ("SegmentMax", {"num_segments": 4}, [f32(5, 2), i32(0, 0, 1, 3, 3)]),
    ("UnsortedSegmentMin", {"num_segments": 4}, [f32(5), i32(3, 0, 3, 1, 0)]),
    ("UnsortedSegmentProd", {"num_segments": 3}, [f32(4), i32(2, 0, 2, 0)]),
    ("SegmentMean", {"num_segments": 3}, [f32(4, 2), i32(0, 0, 2, 2)]),
    ("Bincount", {"size": 5}, [i32(1, 4, 4, 0, 7), np.zeros(0, np.float32)]),
    ("Bincount", {"size": 4}, [i32(1, 3, 3, 0), f32(4)]),
    ("ReverseSequence", {"seq_dim": 0, "batch_dim": 1},
     [f32(5, 2, 3), i32(2, 4)]),
    ("Roll", {"shift": [1, -2], "axis": [0, 1]}, [f32(3, 4)]),
    ("Einsum", {"equation": "bij,bjk->bik"}, [f32(2, 3, 4), f32(2, 4, 2)]),
    ("L2Loss", {}, [f32(3, 4)]),
    ("AddN", {}, [f32(2, 2), f32(2, 2), f32(2, 2)]),
    ("Fill", {"dims": [2, 3]}, [np.float32(1.5)]),
    ("Cast", {"dst": "bfloat16"}, [f32(6)]),
    ("Cast", {"dst": "int32"}, [f32(6) * 4]),
    ("Conv2D", {"strides": [1, 2, 2, 1], "dilations": [1, 2, 2, 1],
                "padding": "SAME"}, [f32(1, 7, 6, 2), f32(3, 3, 2, 3)]),
    ("DepthwiseConv2dNative", SAME4, [f32(1, 5, 5, 3), f32(3, 3, 3, 1)]),
    ("MaxPool", {"ksize": [1, 3, 3, 1], **SAME4}, [f32(1, 5, 6, 2)]),
    ("AvgPool", {"ksize": [1, 3, 2, 1], **SAME4}, [f32(2, 5, 5, 1)]),
    ("Conv3D", {"strides": [1, 2, 1, 2, 1], "padding": "SAME"},
     [f32(1, 5, 4, 5, 2), f32(2, 3, 2, 2, 3)]),
    ("MaxPool3D", {"ksize": [1, 2, 2, 2, 1], "strides": [1, 2, 2, 2, 1],
                   "padding": "SAME"}, [f32(1, 3, 5, 4, 2)]),
    ("AvgPool3D", {"ksize": [1, 2, 2, 2, 1], "strides": [1, 2, 2, 2, 1],
                   "padding": "SAME"}, [f32(1, 3, 5, 4, 2)]),
    ("Conv2DBackpropInput", {"input_sizes": [1, 7, 7, 2],
                             "strides": [1, 2, 2, 1], "padding": "VALID"},
     [f32(3, 3, 2, 4), f32(1, 3, 3, 4)]),
    ("Dilation2D", {"strides": [1, 1, 1, 1], "rates": [1, 2, 2, 1],
                    "padding": "SAME"}, [f32(1, 6, 6, 2), f32(2, 2, 2)]),
    ("SpaceToBatchND", {"block_shape": [2, 2], "paddings": [[1, 1], [0, 2]]},
     [f32(1, 4, 4, 3)]),
    ("BatchToSpaceND", {"block_shape": [2, 2], "crops": [[1, 0], [0, 1]]},
     [f32(4, 2, 3, 1)]),
    ("ResizeBilinear", {"size": [3, 5]}, [f32(1, 6, 4, 2)]),
    ("ResizeNearestNeighbor", {"size": [3, 7]}, [f32(1, 6, 4, 2)]),
    ("CropAndResize", {"crop_size": [1, 3], "extrapolation_value": -1.0},
     [f32(2, 6, 6, 1), np.asarray([[0.1, -0.2, 0.9, 1.3],
                                   [0.0, 0.0, 1.0, 1.0]], np.float32),
      i32(1, 0)]),
    ("LeakyRelu", {"alpha": 0.3}, [f32(8)]),
    ("LRN", {"depth_radius": 2, "bias": 1.5, "alpha": 0.2, "beta": 0.6},
     [f32(1, 2, 2, 7)]),
    ("InvertPermutation", {}, [i32(3, 0, 4, 1, 2)]),
    ("BroadcastArgs", {}, [i32(3, 1), i32(4, 1, 5)]),
]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32) if str(np.asarray(x).dtype) == \
        "bfloat16" else np.asarray(x)


@pytest.mark.parametrize("op,params,ins", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_builder_matches_jax(op, params, ins):
    want = jtf._BUILDERS[op](dict(params))(*ins)
    got = ttf._BUILDERS[op](dict(params))(*[ttf._to_torch(a) for a in ins])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _host(g), _host(w)
        assert g.shape == w.shape, (op, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=op)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=op)


def test_betainc_matches_scipy():
    special = pytest.importorskip("scipy.special")
    a, b = np.meshgrid(np.linspace(0.2, 20, 12), np.linspace(0.2, 20, 12))
    x = rng.uniform(0, 1, a.shape)
    x[0, :3] = [0.0, 1.0, 0.5]
    got = ttf._BUILDERS["Betainc"]({})(*[torch.from_numpy(v.astype(
        np.float64)) for v in (a, b, x)]).numpy()
    np.testing.assert_allclose(got, special.betainc(a, b, x), rtol=1e-9,
                               atol=1e-12)
