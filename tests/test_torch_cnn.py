"""The port's VGG-16 and ResNet-18 against the JAX reference, pruned by
``pattern_shared`` and packed, at width 0.125 on 16 x 16 images.

Both packages start from the reference's init, handed over as numpy
through ``repro_torch.convert``; each prunes (channel-shared 4-of-9 library
patterns plus connectivity at alpha 0.25, the quickstart's composition)
and packs by itself. Pruned weights and packed buffers must be bit-equal.
Logits on the same synthetic images (Uniform[0, 255] pixels scaled to
[0, 1], from numpy) must agree within 1e-4 absolute in fp32, dense-pruned
and packed alike: the per-op tolerance is 2e-5 and a forward chains 13
(VGG) or 20 (ResNet) convs; the top-1 class must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.models.cnn import resnet18 as j_resnet18
from repro.models.cnn import vgg16 as j_vgg16
from repro.utils.tree import tree_paths
from repro_torch.convert import packed_from_jax, params_from_jax
from repro_torch.core import PruneConfig, greedy_prune
from repro_torch.models import resnet18, vgg16
from repro_torch.models.cnn import _same_pad, conv2d
from repro_torch.sparse import is_packed
from repro_torch.utils.tree import tree_items

LOGIT_ATOL = 1e-4
HWC = (16, 16, 3)
ARCHS = {"vgg16": (j_vgg16, vgg16), "resnet18": (j_resnet18, resnet18)}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def both(request):
    """(ref model, ref artifact, port model, port artifact, images)."""
    j_ctor, t_ctor = ARCHS[request.param]
    jmodel = j_ctor(num_classes=10, width_mult=0.125, image_hwc=HWC)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for lp in np_params["layers"]:          # nonzero biases: init zeros them
        lp["bias"] = (rng.standard_normal(lp["bias"].shape) * 0.1).astype(
            np.float32)
    jart = j_greedy_prune(jax.tree.map(jnp.asarray, np_params),
                          JPruneConfig(scheme="pattern_shared", alpha=0.25)
                          ).to_artifact().pack()
    tmodel = t_ctor(num_classes=10, width_mult=0.125, image_hwc=HWC,
                    device="cpu")
    tart = greedy_prune(params_from_jax(np_params, None, "cpu"),
                        PruneConfig(scheme="pattern_shared", alpha=0.25),
                        device="cpu").pack(verify=True, device="cpu")
    images = (rng.integers(0, 256, (6, *HWC)) / 255.0).astype(np.float32)
    return jmodel, jart, tmodel, tart, images


def test_param_shapes_match_reference(both):
    jmodel, _, tmodel, _, _ = both
    expected = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want = {p: tuple(leaf.shape) for p, leaf in
            zip(tree_paths(expected), jax.tree.leaves(expected))}
    assert tmodel.param_shapes() == want
    got = tmodel.init(torch.Generator().manual_seed(0))
    assert {p: tuple(t.shape) for p, t in tree_items(got)} == want


def test_pruned_and_packed_buffers_bit_equal(both):
    _, jart, _, tart, _ = both
    want = dict(tree_items(params_from_jax(
        jax.tree.map(np.asarray, jart.params), None, "cpu")))
    for path, leaf in tree_items(tart.params):
        assert torch.equal(leaf, want[path]), path
    want = dict(tree_items(packed_from_jax(
        jax.tree.map(np.asarray, jart.packed), None, "cpu")))
    n_packed = 0
    for path, leaf in tree_items(tart.packed):
        ref = want[path]
        assert is_packed(leaf) == is_packed(ref), path
        if not is_packed(leaf):
            assert torch.equal(leaf, ref), path
            continue
        n_packed += 1
        assert (leaf.scheme, leaf.names, leaf.shape) == (
            ref.scheme, ref.names, ref.shape), path
        for a, b in zip(leaf.buffers, ref.buffers):
            assert a.dtype == b.dtype and torch.equal(a, b), path
    # every 3x3 conv packs (ResNet's 1x1 projections and the head do not):
    # VGG-16 has 13, ResNet-18 17
    n_3x3 = sum(leaf.ndim == 4 and leaf.shape[-1] == 3
                for _, leaf in tree_items(tart.params))
    assert n_packed == n_3x3 == (13 if len(tart.params["layers"]) == 13
                                 else 17)
    assert tart.summary()["packed_leaves"] == n_packed
    assert tart.summary()["bytes_ratio"] > 2.0


@pytest.mark.parametrize("packed", [False, True])
def test_logits_match_reference(both, packed):
    jmodel, jart, tmodel, tart, images = both
    want = np.asarray(jmodel.apply(jart.bind(jmodel, packed=packed),
                                   jnp.asarray(images)))
    got = tmodel.apply(tart.bind(tmodel, packed=packed),
                       torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


def test_strided_leaves_are_dense_after_bind(both):
    _, _, tmodel, tart, _ = both
    tree = dict(tree_items(tart.bind(tmodel, packed=True)))
    strided = set(getattr(tmodel, "unpackable_leaf_paths", lambda: [])())
    dense = dict(tree_items(tart.params))
    for path, leaf in tree.items():
        if path in strided:
            assert not is_packed(leaf) and torch.equal(leaf, dense[path])
        elif path.endswith("/w") and path.startswith("layers/"):
            assert is_packed(leaf), path
    # ResNet-18 opens stages 2-4 with a strided conv; VGG has none
    assert len(strided) == (3 if len(tmodel.param_shapes()) > 30 else 0)
    assert tart.bind_report == {"fallbacks": {}}


def test_same_padding_matches_xla():
    """Strided SAME convs pad (0, 1) as XLA does, not (1, 1)."""
    assert _same_pad(16, 3, 2) == (0, 1)
    assert _same_pad(15, 3, 2) == (1, 1)
    assert _same_pad(16, 1, 2) == (0, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 7, 4)).astype(np.float32)
    for shape, stride in (((6, 4, 3, 3), 2), ((6, 4, 1, 1), 2),
                          ((6, 4, 3, 3), 1)):
        w = rng.standard_normal(shape).astype(np.float32)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
            dimension_numbers=("NHWC", "OIHW", "NHWC"))
        got = conv2d(torch.from_numpy(x), torch.from_numpy(w), stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
