"""The port's classifier batch norm: which path runs, and what the counters read.

``models.classifiers.FrozenBatchNorm2d`` takes the hand-written pass
(``ops.frozen_bn.frozen_bn``) in eval mode on the card where autograd
records nothing, and the separate ops everywhere else. Here the CPU stands
in for the card: the wrapper's device check is widened to CPU tensors and
its launcher replaced by the plain chain, so the tests see which layers
would launch, with what, and that the logits stay the plain path's bit for
bit. State-dict keys stay torchvision's; a torchvision-layout file (written
by a plain ``torch.nn`` MobileNetV2 here) loads and gives its logits.
"""

import pytest
import torch
import torch.nn as tnn

from stylex_tpu_torch.models import classifiers as tc
from stylex_tpu_torch.ops import frozen_bn as fbn
from stylex_tpu_torch.utils import tracing


def _port_net(kind, seed=0):
    torch.manual_seed(seed)
    net = tc.MobileNetV2() if kind == "mobilenet" else tc.ResNet18()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, tc.FrozenBatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.5 + 0.75)
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return net.eval()


@pytest.fixture
def card_stand_in(monkeypatch):
    """The CPU standing in for the card, the launcher replaced by the plain
    chain; returns the launches made, as (shape, dtype, relu6, residual)."""
    launches = []

    def launcher(y, mean, scale, bias, residual=None, relu6=False):
        others = [mean, scale, bias] + ([] if residual is None else [residual])
        assert all(t.dtype == y.dtype for t in others), "the kernel takes one dtype"
        launches.append((tuple(y.shape), y.dtype, relu6, residual is not None))
        return fbn.frozen_bn_plain(y, mean, scale, bias, residual, relu6)

    monkeypatch.setattr(fbn, "takes_kernel", lambda y: y.device.type == "cpu")
    monkeypatch.setattr(fbn, "frozen_bn", launcher)
    return launches


def _counted(fn):
    tracing.reset()
    with tracing.recording():
        out = fn()
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    return out, counters.get("classifier.bn_fused", 0), counters.get("classifier.bn_plain", 0)


@pytest.mark.parametrize("kind,dtype,layers,relu6,residual", [
    ("mobilenet", torch.float32, 52, 35, 10),
    ("mobilenet", torch.bfloat16, 52, 35, 10),
    ("resnet", torch.float32, 20, 0, 0),
])
def test_port_batch_norm_fuses_in_eval_without_autograd(card_stand_in, kind, dtype, layers,
                                                       relu6, residual):
    """Eval mode with autograd off (or nothing needing a gradient) takes the
    fused path at every batch norm, in float32 and bfloat16, ReLU6 and
    residual handed over in the input's dtype; the logits equal the plain
    path's bit for bit."""
    net = _port_net(kind).to(dtype)
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(1)).to(dtype)
    want = net(x).detach()  # the parameters need a gradient: the plain path
    assert card_stand_in == []
    with torch.no_grad():
        got, fused, plain = _counted(lambda: net(x))
    assert (fused, plain) == (layers, 0)
    assert len(card_stand_in) == layers
    assert {d for _, d, _, _ in card_stand_in} == {dtype}
    assert sum(r for _, _, r, _ in card_stand_in) == relu6
    assert sum(res for _, _, _, res in card_stand_in) == residual
    assert torch.equal(got, want)
    # grad mode on, but nothing needs a gradient: nothing is recorded either
    for p in net.parameters():
        p.requires_grad_(False)
    got, fused, plain = _counted(lambda: net(x))
    assert (fused, plain) == (layers, 0) and torch.equal(got, want)


def _plain_cases(net, x):
    """(label, thunk) of the forwards that must take the plain path."""
    gen = torch.Generator().manual_seed(0)

    def train_mode():
        net.train()
        try:
            return net(x, gen)
        finally:
            net.eval()

    def input_needs_grad():
        return net(x.clone().requires_grad_(True))

    def params_need_grad():
        return net(x)  # parameters require a gradient by default

    return [("train", train_mode), ("input grad", input_needs_grad),
            ("param grad", params_need_grad)]


@pytest.mark.parametrize("case", ["train", "input grad", "param grad", "cpu"])
def test_port_batch_norm_keeps_the_plain_path(card_stand_in, monkeypatch, case):
    """Train mode, a forward under autograd (the input or the parameters
    needing a gradient), and a CPU tensor with the real device check take
    the separate ops, counted as ``classifier.bn_plain``."""
    net = _port_net("mobilenet")
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    if case == "cpu":
        monkeypatch.undo()  # the real check: no CPU tensor takes the kernel
        monkeypatch.setattr(fbn, "frozen_bn", lambda *a, **k: pytest.fail("launched"))
        with torch.no_grad():
            _, fused, plain = _counted(lambda: net(x))
    else:
        thunk = dict(_plain_cases(net, x))[case]
        _, fused, plain = _counted(thunk)
    assert (fused, plain) == (0, 52)
    assert card_stand_in == []


def _t_conv_bn_relu6(cin, cout, k, s, groups=1):
    return tnn.Sequential(tnn.Conv2d(cin, cout, k, s, (k - 1) // 2, groups=groups, bias=False),
                          tnn.BatchNorm2d(cout), tnn.ReLU6())


class _TInvertedResidual(tnn.Module):
    def __init__(self, cin, cout, stride, t):
        super().__init__()
        hidden = cin * t
        layers = [_t_conv_bn_relu6(cin, hidden, 1, 1)] if t != 1 else []
        layers += [_t_conv_bn_relu6(hidden, hidden, 3, stride, groups=hidden),
                   tnn.Conv2d(hidden, cout, 1, bias=False), tnn.BatchNorm2d(cout)]
        self.conv = tnn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class _TMobileNetV2(tnn.Module):
    """MobileNetV2 (Sandler et al. 2018) in plain ``torch.nn``, with
    torchvision's state-dict keys: the layout of a torchvision file."""

    def __init__(self, num_classes=2):
        super().__init__()
        plan = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        feats, cin = [_t_conv_bn_relu6(3, 32, 3, 2)], 32
        for t, c, n, s in plan:
            for i in range(n):
                feats.append(_TInvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
        feats.append(_t_conv_bn_relu6(320, 1280, 1, 1))
        self.features = tnn.Sequential(*feats)
        self.classifier = tnn.Sequential(tnn.Dropout(0.2), tnn.Linear(1280, num_classes))

    def forward(self, x):
        return self.classifier(self.features(x).mean(dim=(2, 3)))


def test_port_mobilenet_state_dict_keys_and_torchvision_file(tmp_path):
    """The state dict keeps torchvision's keys (no ReLU6 entries, which hold
    nothing), and a torchvision-layout file loads into the port and gives
    the plain ``torch.nn`` network's logits."""
    torch.manual_seed(0)
    oracle = _TMobileNetV2().eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.5 + 0.75)
    assert list(tc.MobileNetV2().state_dict()) == list(oracle.state_dict())
    path = tmp_path / "mobilenet_v2.pt"
    torch.save(oracle.state_dict(), path)
    bundle = tc.build_classifier("mobilenet", image_size=32, checkpoint_path=str(path),
                                 device="cpu")
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        torch.testing.assert_close(bundle.net(x), oracle(x), rtol=1e-4, atol=1e-5)
