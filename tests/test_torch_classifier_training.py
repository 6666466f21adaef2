"""Classifier pretraining: the port's ``ClassifierTrainer`` against the JAX
package's, on the CPU, from the same flax variables and batches.

Both packages run in float64 (``jax.enable_x64``; the JAX variables, the
port's net and the images in float64), where their arithmetic differs only
in summation order: one train step of MobileNetV2 (dropout off: ``dropout_rate=0`` on
both sides, since the draws cannot be replayed) and of ResNet-18 (no
dropout), one epoch with the MobileNetV2 freeze mask, and ``fit`` over the
ResNet progressive stages match in loss, accuracy and running statistics
to rtol 1e-9 / atol 1e-12, and in parameters after Adam to rtol 1e-9 /
atol 1e-4 x lr (Adam's step lr g / (|g| + 1e-8) on a gradient that is 0
but for rounding).

In float32 one step matches in loss (rtol 1e-4), accuracy (equal) and
running statistics (atol 1e-4 x the layer's largest running standard
deviation, or variance): the batch mean and the biased variance as
E[x²] - E[x]², as flax computes them, lose digits to cancellation, and
XLA's CPU reductions sum in sequence, so the two packages' float32
gradients, and Adam's sign-like first steps on them, differ by more than
rounding; they are held in float64.

Also: the freeze masks equal the JAX package's name for name; the port's
dropout keeps 1 - p of its inputs scaled by 1 / (1 - p) and repeats from a
seed; ``save``/``load`` of ``.msgpack`` and ``.pt``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu.models.classifiers import MobileNetV2 as JMobileNetV2
from stylex_tpu.train import classifier_training as jct
from stylex_tpu_torch.models.classifiers import Dropout, build_classifier
from stylex_tpu_torch.models.convert import (
    classifier_state_dict_from_jax,
    classifier_tree_from_state_dict,
)
from stylex_tpu_torch.train import classifier_training as ct

torch.set_num_threads(2)

LR = 1e-3
N, SIZE, BATCH = 16, 64, 8


def _data(seed=0, dtype=np.uint8):
    """Images as the loaders give them (uint8), or as float64 in [0, 1]:
    XLA fuses the uint8 -> float32 normalisation into the step with its own
    rounding, which a float64 comparison would read."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (N, SIZE, SIZE, 3)).astype(np.uint8)
    if dtype != np.uint8:
        images = images.astype(dtype) / 255.0
    return images, rng.randint(0, 2, N).astype(np.int32)


def _batches(images, labels):
    return lambda epoch=0: ((images[i:i + BATCH], labels[i:i + BATCH])
                            for i in range(0, len(images), BATCH))


def _pair(kind, dtype=np.float32):
    jt = jct.ClassifierTrainer(kind, lr=LR)
    if kind == "mobilenet":
        jt.model = JMobileNetV2(num_classes=2, dropout_rate=0.0)
    jt.init(SIZE)
    jt.variables = jax.tree.map(lambda a: jnp.asarray(a, dtype), jt.variables)
    port = ct.ClassifierTrainer(kind, lr=LR, device="cpu")
    if kind == "mobilenet":
        port.net.classifier[0].p = 0.0
    port.init(SIZE, classifier_state_dict_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jt.variables), kind))
    port.net.to(torch.float64 if dtype == np.float64 else torch.float32)
    return jt, port


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_tree(port):
    sd = {k: v.double() if v.is_floating_point() else v for k, v in port.net.state_dict().items()}
    return _flat(classifier_tree_from_state_dict(sd, port.kind))


def _assert_vars_close(port, want_vars, which=("params", "batch_stats")):
    got = _port_tree(port)
    for k, w in _flat({n: want_vars[n] for n in which}).items():
        # a gradient that is 0 but for rounding (a bias before a train-mode
        # batch norm) takes Adam's step lr g / (|g| + 1e-8): up to 1e-4 lr
        # for float64 noise of 1e-12
        atol = 1e-4 * LR if k.startswith("['params']") else 1e-12
        np.testing.assert_allclose(got[k], w, rtol=1e-9, atol=atol, err_msg=k)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("kind", ["mobilenet", "resnet"])
def test_train_step_matches_jax(kind, x64):
    jt, port = _pair(kind, np.float64)
    jt.set_trainable()
    port.set_trainable()
    images, labels = _data(dtype=np.float64)
    new_vars, _, loss_j, acc_j = jt._train_step(
        jt.variables, jt.opt_state, jnp.asarray(images[:BATCH]), jnp.asarray(labels[:BATCH]),
        jax.random.PRNGKey(0))
    loss, acc = port.train_step(images[:BATCH], labels[:BATCH])
    assert loss.dtype == torch.float64 and np.asarray(loss_j).dtype == np.float64
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-9)
    assert float(acc) == float(acc_j)
    _assert_vars_close(port, new_vars)


@pytest.mark.parametrize("kind", ["mobilenet", "resnet"])
def test_float32_train_step_matches_jax(kind):
    jt, port = _pair(kind)
    jt.set_trainable()
    port.set_trainable()
    images, labels = _data()
    new_vars, _, loss_j, acc_j = jt._train_step(
        jt.variables, jt.opt_state, jnp.asarray(images[:BATCH]), jnp.asarray(labels[:BATCH]),
        jax.random.PRNGKey(0))
    loss, acc = port.train_step(images[:BATCH], labels[:BATCH])
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    assert float(acc) == float(acc_j)
    got = _port_tree(port)
    want = _flat({"batch_stats": new_vars["batch_stats"]})
    for k, w in want.items():  # at 1e-4 of the layer's running standard deviation
        scale = np.sqrt(want[k[:-len("['mean']")] + "['var']"].max()) if k.endswith(
            "['mean']") else w.max()
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * scale, err_msg=k)


def test_freeze_masks_match_jax():
    jt, _ = _pair("mobilenet")
    for amount, freeze_all in ((15, False), (0, False), (1, False), (5, False), (18, False),
                               (-1, False), (15, True)):
        want = jct.mobilenet_freeze_mask(jt.variables["params"], amount, freeze_all)
        got = ct.mobilenet_freeze_mask(amount, freeze_all)
        assert set(got) == set(want)
        for name, sub in want.items():
            assert set(jax.tree.leaves(sub)) == {got[name]}, (amount, freeze_all, name)
    names = ["stem", "layer1_0", "layer3_1", "layer4_0", "fc"]
    for j_stage, p_stage in zip(jct.resnet_progressive_stages(), ct.resnet_progressive_stages()):
        assert [j_stage(n) for n in names] == [p_stage(n) for n in names]


def test_epoch_with_freeze_mask_matches_jax(x64):
    jt, port = _pair("mobilenet", np.float64)
    jt.set_trainable(mask=jct.mobilenet_freeze_mask(jt.variables["params"], 15))
    port.set_trainable(mask=ct.mobilenet_freeze_mask(15))
    frozen = {k: v.clone() for k, v in port.net.named_parameters() if not v.requires_grad}
    # features 0-14 frozen: the stem and blocks 0-13
    assert {ct.module_name("mobilenet", k) for k in frozen} == {
        "stem", *(f"block{i}" for i in range(14))}
    images, labels = _data(dtype=np.float64)
    loader = _batches(images, labels)
    losses_j = []
    for x, y in loader():
        jt.variables, jt.opt_state, loss, _ = jt._train_step(
            jt.variables, jt.opt_state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        losses_j.append(float(loss))
    loss_p = port.train_epoch(loader(), 0)
    np.testing.assert_allclose(loss_p, np.mean(losses_j), rtol=1e-9)
    _assert_vars_close(port, jt.variables)
    for k, v in frozen.items():  # frozen parameters do not move; their statistics do
        assert torch.equal(dict(port.net.named_parameters())[k], v), k
    assert port.evaluate(loader()) == jt.evaluate(loader())
    np.testing.assert_array_equal(port.confusion_matrix(loader()), jt.confusion_matrix(loader()))


def test_fit_over_progressive_stages_matches_jax(x64, tmp_path, capsys):
    jt, port = _pair("resnet", np.float64)
    images, labels = _data(dtype=np.float64)
    train, valid = _batches(images, labels), _batches(*_data(1, np.float64))
    stages_j, stages_p = jct.resnet_progressive_stages(), ct.resnet_progressive_stages()
    hist_j = jt.fit(train, valid, 2, str(tmp_path / "j.msgpack"), stages=stages_j)
    hist_p = port.fit(train, valid, 2, str(tmp_path / "p.pt"), stages=stages_p)
    assert port.trainable["layer4_1"] and not port.trainable["layer3_0"]  # stage 1
    for epoch in ("epoch_0", "epoch_1"):
        np.testing.assert_allclose(hist_p[epoch]["loss"], hist_j[epoch]["loss"], rtol=1e-9)
        assert hist_p[epoch]["train_acc"] == hist_j[epoch]["train_acc"]
        assert hist_p[epoch]["val_acc"] == hist_j[epoch]["val_acc"]
    assert hist_p["best_val_accuracy"] == hist_j["best_val_accuracy"]
    _assert_vars_close(port, jt.variables)
    results = port.test(valid, str(tmp_path / "r" / "p.json"))
    assert results == jt.test(valid) == {"test_accuracy": hist_p["best_val_accuracy"]}
    assert (tmp_path / "r" / "p.json").exists()


def test_saved_msgpack_reads_in_both_packages(tmp_path):
    """A float32 trainer's ``.msgpack`` checkpoint: the port's
    ``build_classifier`` gives its logits bit for bit, the JAX package's to
    float32 rounding."""
    from stylex_tpu.models.classifiers import build_classifier as j_build_classifier

    port = ct.ClassifierTrainer("resnet", device="cpu")
    port.init(SIZE, seed=2)
    port.set_trainable(ct.resnet_progressive_stages()[1])
    images, labels = _data()
    port.train_step(images[:BATCH], labels[:BATCH])  # running statistics move
    port.save(str(tmp_path / "c.msgpack"))
    want = port.logits(images[:4])
    x = torch.from_numpy(images[:4]).permute(0, 3, 1, 2).float() / 255.0
    clf = build_classifier("resnet", SIZE, checkpoint_path=str(tmp_path / "c.msgpack"),
                           device="cpu")
    assert torch.equal(clf.net(ct.imagenet_normalize(x)), want)
    jclf = j_build_classifier("resnet", SIZE, checkpoint_path=str(tmp_path / "c.msgpack"))
    got = jclf.apply_fn(jclf.variables, ct.imagenet_normalize(x).permute(0, 2, 3, 1).numpy())
    np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=1e-4, atol=1e-5)


def test_save_and_load_both_formats(tmp_path):
    port = ct.ClassifierTrainer("mobilenet", device="cpu")
    port.init(SIZE, seed=3)
    images, _ = _data()
    want = port.logits(images[:2])
    for name in ("c.msgpack", "c.pt"):
        port.save(str(tmp_path / name))
        other = ct.ClassifierTrainer("mobilenet", device="cpu")
        other.load(str(tmp_path / name))
        assert torch.equal(other.logits(images[:2]), want)


def test_dropout_keep_rate_scale_and_seed():
    drop = Dropout(0.2).train()
    x = torch.ones(200_000)
    y = drop(x, torch.Generator().manual_seed(5))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.8))
    assert torch.equal(drop(x, torch.Generator().manual_seed(5)), y)
    assert not torch.equal(drop(x, torch.Generator().manual_seed(6)), y)
    with pytest.raises(ValueError, match="Generator"):
        drop(x)
    assert torch.equal(drop.eval()(x), x)
    # in a MobileNetV2 train step the mask comes from the trainer's generator
    a = ct.ClassifierTrainer("mobilenet", seed=1, device="cpu")
    b = ct.ClassifierTrainer("mobilenet", seed=1, device="cpu")
    for t in (a, b):
        t.init(SIZE, seed=0)
        t.set_trainable()
    images, labels = _data()
    assert torch.equal(a.train_step(images[:4], labels[:4])[0],
                       b.train_step(images[:4], labels[:4])[0])
