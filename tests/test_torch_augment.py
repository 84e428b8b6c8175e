"""Device augmentation in the port (``nn/augment.py``) against the JAX
package's, on the CPU.

- Deterministic ops on uint8 images (flips, ``scale``, ``scale_to``,
  ``normalize``, ``grayscale``, a fixed ``rotate``): exactly the JAX
  values. ``resize``: within 1e-4 absolute on [0, 255] pixels (both are
  the antialiased triangle filter; the port's sums round in another
  order: 3.05e-5 measured, two fp32 ulps at 255).
- Random ops (crop, random flip, random brightness, random rotation)
  with the JAX draws injected (``augment.draw`` replaced by the JAX
  package's ``fold_in(fold_in(PRNGKey(seed), t), op)`` draws): exactly
  the JAX chain. Without injection the port's own draws are a function
  of the seed, the step and the op, in range, and differ from step to
  step.
- ``fit(augment=)`` of a tiny conv net on uint8 images against the JAX
  net, draws injected: params and score within 2e-4 (the
  ``test_torch_graph`` fit tolerance) after two steps.
- ``steps_per_dispatch=2`` equals two single steps to the bit; the
  augmentation's signature is part of the step-cache key; the crop is
  one gather whatever the batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jdata
from deeplearning4j_tpu.data import image as jimg
from deeplearning4j_tpu.nn import augment as jaug
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data import image as timg
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import augment as aug
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.normalization import StepKey
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

FIT_TOL = 2e-4
SEED = 11


def images(b=3, c=3, h=12, w=14, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (b, c, h, w)).astype(np.uint8)


def run_both(build, x, t=0, seed=SEED):
    ours = build(aug.DeviceAugmentation(seed))
    theirs = build(jaug.DeviceAugmentation(seed))
    got = ours.apply(torch.from_numpy(x), ours.step_key(
        torch.tensor(t, dtype=torch.int32)))
    want = theirs.apply(jnp.asarray(x), theirs.step_key(jnp.int32(t)))
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


DETERMINISTIC = {
    "flip_h": lambda a: a.flip(1),
    "flip_v": lambda a: a.flip(0),
    "flip_both": lambda a: a.flip(-1),
    "scale": lambda a: a.scale(1 / 255.0),
    "scale_to": lambda a: a.scale_to(-1.0, 1.0),
    "normalize": lambda a: a.normalize((120.0, 110.0, 100.0),
                                       (60.0, 55.0, 50.0)),
    "grayscale": lambda a: a.grayscale(),
    "brightness": lambda a: a.brightness(40.0),
    "rotate": lambda a: a.rotate(23.0),
    "chain": lambda a: a.flip(-1).scale_to(0, 1).normalize(
        (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)).grayscale(),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_ops_equal_jax(name):
    got, want = run_both(DETERMINISTIC[name], images())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(9, 10), (12, 14), (20, 24), (5, 7)])
def test_resize_is_within_the_stated_tolerance(hw):
    got, want = run_both(lambda a: a.resize(*hw), images())
    assert got.shape == want.shape == (3, 3) + hw
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def jax_draw(kind, key, b, device, **kw):
    """The JAX package's draw for the op ``key`` names (the port's key
    is ``StepKey(seed, t, (aug path, op))``)."""
    seed, t, op = key.seed, int(key.t), key.path[-1]
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), t),
                           op)
    if kind == "crop":
        d = jax.random.randint(k, (b, 2), 0, kw["high"])
    elif kind == "random_flip":
        d = jax.random.randint(k, (b,), 0, 3)
    elif kind == "brightness":
        d = jax.random.uniform(k, (b, 1, 1, 1), minval=-kw["delta"],
                               maxval=kw["delta"]).reshape(b)
    else:
        d = jax.random.uniform(k, (b,), minval=-kw["angle"],
                               maxval=kw["angle"])
    return torch.from_numpy(np.array(d)).to(device)


@pytest.fixture()
def injected(monkeypatch):
    monkeypatch.setattr(aug, "draw", jax_draw)


RANDOM = {
    "crop": lambda a: a.crop(3),
    "random_flip": lambda a: a.random_flip(),
    "brightness": lambda a: a.brightness(30.0, random=True),
    "rotate": lambda a: a.rotate(40.0, random=True),
    "imagenet": lambda a: a.crop(4).random_flip().normalize(
        (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)),
}


@pytest.mark.parametrize("t", [0, 5])
@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_ops_equal_jax_with_its_draws(injected, name, t):
    got, want = run_both(RANDOM[name], images(b=6), t=t)
    if name == "rotate":
        # cos/sin of the same fp32 angles: the gather weights agree to
        # fp32 rounding
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


def test_own_draws_are_in_range_and_move_with_the_step():
    key = StepKey(3, torch.tensor(7, dtype=torch.int32), (1, 0))
    off = aug.draw("crop", key, 64, "cpu", high=33)
    assert off.shape == (64, 2) and off.min() >= 0 and off.max() <= 32
    assert len(set(off.flatten().tolist())) > 20
    modes = aug.draw("random_flip", key, 300, "cpu")
    assert set(modes.tolist()) == {0, 1, 2}
    u = aug.draw("brightness", key, 1000, "cpu", delta=2.0)
    assert float(u.min()) >= -2.0 and float(u.max()) < 2.0
    assert abs(float(u.mean())) < 0.2
    a = aug.DeviceAugmentation(1).crop(4).random_flip()
    x = torch.from_numpy(images(b=8, h=16, w=16))
    s0 = a.apply(x, a.step_key(torch.tensor(0, dtype=torch.int32)))
    s0b = a.apply(x, a.step_key(torch.tensor(0, dtype=torch.int32)))
    s1 = a.apply(x, a.step_key(torch.tensor(1, dtype=torch.int32)))
    assert torch.equal(s0, s0b) and not torch.equal(s0, s1)
    assert s0.shape == (8, 3, 12, 12) and a.output_hw(16, 16) == (12, 12)


def test_the_crop_is_one_gather_whatever_the_batch():
    """The ops the crop dispatches (each one or a few kernels on the card)
    do not depend on B: one batched index, no loop over the images."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))
    a = aug.DeviceAugmentation(0).crop(2).random_flip()
    seen = []
    for b in (2, 64):
        x = torch.from_numpy(images(b=b))
        t = torch.tensor(0, dtype=torch.int32)
        with Ops() as mode:
            out = a.apply(x, a.step_key(t))
        assert out.shape == (b, 3, 10, 12)
        seen.append(mode.ops)
    assert seen[0] == seen[1]
    assert sum("aten.index.Tensor" in op for op in seen[0]) == 1


def test_from_transforms_maps_the_host_presets():
    t = [timg.FlipImageTransform(1), timg.CropImageTransform(2),
         timg.ScaleImageTransform(0.5)]
    j = [jimg.FlipImageTransform(1), jimg.CropImageTransform(2),
         jimg.ScaleImageTransform(0.5)]
    assert aug.DeviceAugmentation.from_transforms(t, seed=4).signature() == \
        jaug.DeviceAugmentation.from_transforms(j, seed=4).signature()
    with pytest.raises(ValueError):
        aug.DeviceAugmentation.from_transforms([object()])


# ------------------------------------------------------------ fit(augment=)
def _conf(Conf, M, It, upd):
    return (Conf.Builder().seed(9).updater(upd.Adam(1e-2))
            .weightInit("xavier").list()
            .layer(M.ConvolutionLayer(kernelSize=(3, 3), nOut=4,
                                      activation="relu"))
            .layer(M.SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                      stride=(2, 2)))
            .layer(M.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(It.convolutional(10, 10, 3)).build())


def _chain(mod):
    return mod.DeviceAugmentation(SEED).crop(2).random_flip().normalize(
        (120.0, 110.0, 100.0), (60.0, 55.0, 50.0))


def _data(n=4, b=5):
    rng = np.random.default_rng(2)
    return [(rng.integers(0, 256, (b, 3, 12, 12)).astype(np.uint8),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)])
            for _ in range(n)]


def test_fit_with_augmentation_matches_jax(injected):
    j = JMLN(_conf(JConf, jlayers, JInputType, jupd))
    j.init()
    t = MultiLayerNetwork(_conf(NeuralNetConfiguration, tlayers, InputType,
                                tupd)).params_from_jax(j._params, j._states,
                                                       device="cpu")
    for x, y in _data(2):
        j.fit(jdata.DataSet(x, y), augment=_chain(jaug))
        t.fit(DataSet(x, y), augment=_chain(aug))
        np.testing.assert_allclose(t.score(), float(j.score()),
                                   rtol=FIT_TOL, atol=FIT_TOL)
    for i, (pj, pt) in enumerate(zip(j._params, t._params)):
        for k, v in pj.items():
            np.testing.assert_allclose(pt[k].detach().numpy(),
                                       np.asarray(v), rtol=FIT_TOL,
                                       atol=FIT_TOL, err_msg=f"{i}.{k}")


def test_two_steps_a_dispatch_equal_two_single_steps_and_the_key():
    data = [DataSet(x, y) for x, y in _data()]

    def net():
        n = MultiLayerNetwork(_conf(NeuralNetConfiguration, tlayers,
                                    InputType, tupd)).init(device="cpu")
        n.setDeviceAugmentation(_chain(aug))
        return n
    a, b = net(), net()
    a.fit(data, steps_per_dispatch=2)
    for ds in data:
        b.fit(ds)
    for x, y in zip(a._dispatch_state(), b._dispatch_state()):
        assert torch.equal(x, y)
    sig = _chain(aug).signature()
    assert (False, False, 2, ("augment", sig)) in a._step_cache
    assert (False, False, 1, ("augment", sig)) in b._step_cache
    # an equal chain keeps the step; another one is a step of its own
    b.fit(data[0], augment=_chain(aug))
    assert len(b._step_cache) == 1
    b.fit(data[0], augment=aug.DeviceAugmentation(SEED).crop(2))
    assert len(b._step_cache) == 2
    b.setDeviceAugmentation(None)
    b.fit(DataSet(data[0].features[:, :, :10, :10], data[0].labels))
    assert (False, False, 1) in b._step_cache
