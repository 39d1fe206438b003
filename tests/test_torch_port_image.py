"""The port's image feature modules against the JAX package, on CPU.

``feature/preprocessing.py``, the 25 ops of ``feature/image/transforms.py``,
``feature/image/spec.py``, ``ImageSet``, the pretrained bundle of
``ZooModel``, ``ImageClassifier``'s preprocessing and ``predict_image_set``,
and ``NNImageReader``. The inputs are seeded numpy images and a temporary
folder of jpgs and pngs written by cv2. Host-side results are compared bit
for bit (the port keeps its own copy of the JAX package's numpy and cv2
code, and a seeded random op makes the same draws from its own
``random.Random``); model outputs within 1e-5 (the f32 forward's
tolerance, ``tests/test_torch_port_resnet.py``).
"""
import json

import cv2
import jax
import numpy as np
import pytest

from analytics_zoo_tpu.feature import preprocessing as jpre
from analytics_zoo_tpu.feature.image import image_set as jis
from analytics_zoo_tpu.feature.image import spec as jspec
from analytics_zoo_tpu.feature.image import transforms as jtr
from analytics_zoo_tpu.models.image.imageclassification import \
    ImageClassifier as JaxImageClassifier
from analytics_zoo_tpu.nnframes import NNImageReader as JaxNNImageReader
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.feature import FeatureSet
from analytics_zoo_tpu_torch.feature import preprocessing as ppre
from analytics_zoo_tpu_torch.feature.image import image_set as pis
from analytics_zoo_tpu_torch.feature.image import spec as pspec
from analytics_zoo_tpu_torch.feature.image import transforms as ptr
from analytics_zoo_tpu_torch.models import ZooModel
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    ImageClassifier
from analytics_zoo_tpu_torch.nnframes import NNImageReader
from torch_port_threads import torch_threads_per_worker  # noqa: F401

SIZE = 32
LABELS = ["cat", "dog", "bird"]


def _image(seed, h=12, w=10, dtype=np.uint8):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (h, w, 3))
    return img.astype(dtype)


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# -- the 25 transforms --------------------------------------------------------

#: op name -> its arguments; a random op takes a seed, and is applied to
#: several images in turn, so its draws are held one by one
TRANSFORMS = {
    "Resize": [(6, 9), (6, 9, "nearest")],
    "AspectScale": [(8,), (8, 11)],
    "CenterCrop": [(5, 7), (20, 20)],
    "RandomCrop": [(5, 7, 3)],
    "FixedCrop": [(0.1, 0.2, 0.8, 0.9), (1, 2, 7, 9, False)],
    "HFlip": [()],
    "Brightness": [(-32.0, 32.0, 4)],
    "Contrast": [(0.5, 1.5, 5)],
    "Saturation": [(0.5, 1.5, 6)],
    "Hue": [(-18.0, 18.0, 7)],
    "ColorJitter": [(8,)],
    "Expand": [((123, 117, 104), 2.5, 9)],
    "ChannelNormalize": [((120.0, 115.5, 100.25), (58.0, 57.5, 57.25))],
    "ChannelOrder": [()],
    "MatToFloats": [()],
    "PixelBytesToMat": [()],
    "RandomPreprocessing": ["inner"],
    "ImageSetToSample": [()],
    "VFlip": [()],
    "Filler": [(0.1, 0.2, 0.5, 0.6, 7.0), (0.0, 0.0, 1.0, 1.0)],
    "ChannelScaledNormalizer": [(100.0, 110.0, 120.0, 0.5)],
    "PixelNormalizer": ["means"],
    "RandomResize": [(5, 9, 11)],
    "RandomAspectScale": [([6, 8, 10], 14, 12)],
    "Grayscale": [()],
}


def _make(module, name, args):
    cls = getattr(module, name)
    if args == "inner":
        return cls(module.HFlip(), 0.5, seed=10)
    if args == "means":
        return cls(_image(99, dtype=np.float32) * 0.5)
    return cls(*args)


def _inputs(name):
    imgs = [_image(i) for i in range(6)] + [_image(7, dtype=np.float32)]
    if name == "PixelBytesToMat":
        return [cv2.imencode(ext, img)[1].tobytes()
                for ext, img in ((".jpg", imgs[0]), (".png", imgs[1]))]
    if name == "PixelNormalizer":
        return imgs[:2] + imgs[-1:]
    return imgs


def test_transforms_cover_the_jax_module():
    jax_ops = {n for n, v in vars(jtr).items() if isinstance(v, type)
               and issubclass(v, jtr.ImageTransform)
               and v is not jtr.ImageTransform and v.__name__ == n}
    assert jax_ops == set(TRANSFORMS) and len(TRANSFORMS) == 25
    assert ptr.Mirror is ptr.HFlip and jtr.Mirror is jtr.HFlip
    assert ptr.RandomTransformer is ptr.RandomPreprocessing


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax_bit_for_bit(name):
    for args in TRANSFORMS[name]:
        got_op, want_op = _make(ptr, name, args), _make(jtr, name, args)
        for i, img in enumerate(_inputs(name)):
            _same(got_op.apply(img), want_op.apply(img),
                  f"{name}{args} on input {i}")
    if name == "Filler":
        with pytest.raises(ValueError):
            ptr.Filler(0.5, 0.0, 0.2, 1.0)
    if name == "PixelNormalizer":
        with pytest.raises(ValueError):
            _make(ptr, name, "means").apply(_image(1, 4, 4))


# -- preprocessing chains, specs ----------------------------------------------


def test_preprocessing_chains_and_stack_records_match_jax():
    recs = [(_image(i, 4, 4, np.float32), np.float32(i)) for i in range(5)]

    def chain(m):
        return m.FeatureLabelPreprocessing(
            m.Lambda(lambda x: x * 2.0) >> m.ArrayToTensor(np.float64),
            m.Lambda(lambda y: y + 1))

    got, want = list(chain(ppre)(recs)), list(chain(jpre)(recs))
    for (gx, gy), (wx, wy) in zip(got, want):
        _same(gx, wx)
        assert gy == wy
    shift = [m.BatchLambda(lambda b: (b[0] - 1.0, b[1])) for m in (ppre, jpre)]
    _same(shift[0].apply(recs[1])[0], shift[1].apply(recs[1])[0])
    both = ppre.Lambda(np.sqrt) >> ppre.BatchLambda(np.floor)
    assert isinstance(both, ppre.ChainedPreprocessing) and not both.batched
    assert (ppre.BatchLambda(np.sqrt) >> ppre.BatchLambda(np.floor)).batched
    for records in (got, [r[0] for r in got],
                    [{"x": r[0], "y": r[1]} for r in got]):
        want_s = jpre.stack_records(records)
        got_s = ppre.stack_records(records)
        out = jax.tree_util.tree_map(np.zeros_like, want_s)
        filled = ppre.stack_records(records, out=out)
        for g, f, w in zip(jax.tree_util.tree_leaves(got_s),
                           jax.tree_util.tree_leaves(filled),
                           jax.tree_util.tree_leaves(want_s)):
            _same(g, w)
            _same(f, w)


def test_build_preprocessing_and_classification_spec_match_jax():
    spec = pspec.classification_spec(8, 6, [1.0, 2.0, 3.0], [4.0, 5.0, 6.0])
    assert spec == jspec.classification_spec(8, 6, [1.0, 2.0, 3.0],
                                             [4.0, 5.0, 6.0])
    assert sorted(pspec.SPEC_OPS) == sorted(jspec.SPEC_OPS)
    spec = spec[:1] + [{"op": "center_crop", "height": 5, "width": 4},
                       {"op": "channel_order"}, {"op": "grayscale"},
                       {"op": "aspect_scale", "min_size": 7},
                       {"op": "mat_to_floats"}] + spec[1:]
    got_chain = pspec.build_preprocessing(spec)
    want_chain = jspec.build_preprocessing(spec)
    for i in range(3):
        _same(got_chain.apply(_image(i, 11, 13)),
              want_chain.apply(_image(i, 11, 13)))
    assert pspec.build_preprocessing([]) is None
    assert pspec.build_preprocessing(None) is None
    with pytest.raises(ValueError, match="unknown preprocessing op"):
        pspec.build_preprocessing([{"op": "random_crop"}])


# -- ImageSet, NNImageReader --------------------------------------------------


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Two class folders of cv2-written jpgs and pngs of several sizes, a
    text file and an undecodable .jpg, and two images at the top."""
    root = tmp_path_factory.mktemp("images")
    for ci, cls in enumerate(("dogs", "cats")):
        (root / cls).mkdir()
        for j in range(3):
            ext = ".png" if j == 1 else ".jpg"
            cv2.imwrite(str(root / cls / f"{cls}{j}{ext}"),
                        _image(10 * ci + j, 14 + j, 9 + 2 * j))
        (root / cls / "notes.txt").write_text("not an image")
    (root / "cats" / "broken.jpg").write_bytes(b"not a jpg")
    cv2.imwrite(str(root / "b.JPG"), _image(30))
    cv2.imwrite(str(root / "a.bmp"), _image(31, 7, 7))
    return root


def _same_image_sets(got, want):
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) and got.paths == want.paths
    for g, w in zip(got.images, want.images):
        _same(g, w)
    if want.labels is None:
        assert got.labels is None
    else:
        _same(got.labels, want.labels)


@pytest.mark.parametrize("with_label", [False, True])
def test_image_set_read_transform_and_featureset_match_jax(image_dir,
                                                           with_label):
    got = pis.ImageSet.read(str(image_dir), with_label=with_label)
    want = jis.ImageSet.read(str(image_dir), with_label=with_label)
    _same_image_sets(got, want)
    if with_label:  # alphabetical classes, one-based: cats 1, dogs 2
        assert list(got.labels) == [1, 1, 1, 2, 2, 2]
        zero = pis.ImageSet.read(str(image_dir), with_label=True,
                                 one_based_label=False)
        assert list(zero.labels) == [0, 0, 0, 1, 1, 1]
    with pytest.raises(ValueError, match="mixed shapes"):
        got.to_featureset()
    got = got.transform(ptr.Resize(8, 6) >> ptr.ChannelNormalize(
        (1.0, 2.0, 3.0), (2.0, 2.0, 2.0)))
    want = want.transform(jtr.Resize(8, 6) >> jtr.ChannelNormalize(
        (1.0, 2.0, 3.0), (2.0, 2.0, 2.0)))
    _same_image_sets(got, want)
    fs = got.to_featureset(shuffle=False)
    assert isinstance(fs, FeatureSet) and fs.size == len(want)
    _same(fs.features, np.stack(want.images).astype(np.float32))
    if with_label:
        _same(fs.labels, want.labels)
    dist = pis.DistributedImageSet(got.images, got.labels)
    assert isinstance(dist.transform(ptr.HFlip()), pis.DistributedImageSet)
    arrays = pis.ImageSet.from_arrays([_image(1, 4, 4)] * 2, [1, 2])
    assert isinstance(arrays, pis.LocalImageSet)
    _same(arrays.to_featureset().features,
          jis.ImageSet.from_arrays([_image(1, 4, 4)] * 2, [1, 2])
          .to_featureset().features)


def test_nn_image_reader_matches_jax(image_dir):
    for kw in (dict(with_label=True, resize_h=9, resize_w=7),
               dict(with_label=False)):
        got = NNImageReader.read_images(str(image_dir), **kw)
        want = JaxNNImageReader.read_images(str(image_dir), **kw)
        assert list(got.columns) == list(want.columns)
        assert list(got["origin"]) == list(want["origin"])
        for g, w in zip(got["image"], want["image"]):
            _same(g, w)
        if kw["with_label"]:
            _same(got["label"].to_numpy(), want["label"].to_numpy())


# -- the pretrained bundle, ImageClassifier -----------------------------------


@pytest.fixture(scope="module")
def classifiers(tmp_path_factory):
    """JAX's ResNet-18 ImageClassifier (3 labelled classes, 32 x 32) with
    materialized weights and its saved bundle, and the port's
    ImageClassifier on the CPU with the same weights."""
    jc = JaxImageClassifier("resnet18", num_classes=3,
                            input_shape=(SIZE, SIZE, 3), labels=LABELS)
    jc._ensure_built()
    jc.default_compile()
    jc.predict(np.zeros((2, SIZE, SIZE, 3), np.float32), batch_size=2)
    est = jc.model.get_estimator()
    weights = {**from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                        est.params)),
               **from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                        est.model_state))}
    pc = ImageClassifier("resnet18", num_classes=3,
                         input_shape=(SIZE, SIZE, 3), labels=LABELS)
    pc.build(device="cpu")
    pc.model.load_state_dict(weights, strict=True)
    jax_bundle = tmp_path_factory.mktemp("jax_bundle")
    jc.save_pretrained(str(jax_bundle))
    return jc, pc, jax_bundle


def test_bundle_json_equals_jax_and_round_trips(classifiers, tmp_path):
    jc, pc, jax_bundle = classifiers
    pc.save_pretrained(str(tmp_path / "b"))
    got = json.loads((tmp_path / "b" / "zoo_bundle.json").read_text())
    want = json.loads((jax_bundle / "zoo_bundle.json").read_text())
    assert got == want
    assert got["format"] == ZooModel.BUNDLE_FORMAT == "zoo-tpu-bundle/1"
    assert [s["op"] for s in got["preprocessing"]] == [
        "resize", "channel_normalize", "to_sample"]
    loaded = ZooModel.load_pretrained(str(tmp_path / "b"), device="cpu")
    assert isinstance(loaded, ImageClassifier) and loaded.labels == LABELS
    assert loaded.model.device.type == "cpu"
    x = np.random.RandomState(2).rand(4, SIZE, SIZE, 3).astype(np.float32)
    np.testing.assert_array_equal(loaded.predict(x, batch_size=4),
                                  pc.predict(x, batch_size=4, device="cpu"))
    img = _image(5, 40, 36)
    _same(loaded.bundled_preprocessing().apply(img),
          pc.preprocessing().apply(img))
    pc.save_model(str(tmp_path / "plain"))
    with pytest.raises(ValueError, match="not a zoo-tpu pretrained bundle"):
        ZooModel.load_pretrained(str(tmp_path / "plain"), device="cpu")
    assert ZooModel.preprocessing_spec(pc) is None


def test_predict_image_set_matches_jax_with_labels(classifiers):
    """Images of other sizes through the classifier's chain (resize to
    32 x 32, ImageNet normalize): the same labels in the same order,
    probabilities within 1e-5; without a label map the class indices."""
    jc, pc, _ = classifiers
    imgs = [_image(60 + i, 40 + i, 36) for i in range(5)]
    got = pc.predict_image_set(pis.ImageSet.from_arrays(imgs), top_k=2,
                               batch_size=4)
    want = jc.predict_image_set(jis.ImageSet.from_arrays(imgs), top_k=2,
                                batch_size=4)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert [label for label, _ in g] == [label for label, _ in w]
        assert all(label in LABELS for label, _ in g)
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w],
                                   rtol=0, atol=1e-5)
    labels, pc.labels = pc.labels, None
    try:
        unlabelled = pc.predict_image_set(pis.ImageSet.from_arrays(imgs),
                                          top_k=3)
    finally:
        pc.labels = labels
    for row, labelled in zip(unlabelled, got):
        assert [c for c, _ in row[:2]] == [LABELS.index(label)
                                           for label, _ in labelled]
        assert all(isinstance(c, int) for c, _ in row)
