"""The JAX package's checkpoints in the port, and the port's in the JAX
package, on the CPU.

A ``model_<n>.ckpt`` written by ``stylex_tpu.utils.checkpoint.save_checkpoint``
(OLD arch with attention and a quantize layer, and the NEW arch with its
per-label Adam) is restored by the port leaf for leaf, bit for bit; one
port train step from it matches the JAX step from the same file (losses at
rtol 1e-4 / atol 1e-5; the gradients, read from the Adam first moments, and
the parameter updates at 1e-4 x their largest magnitude per tree, as
``tests/test_torch_train.py`` holds a step). The port's
``save_jax_checkpoint`` is restored by the JAX package's
``load_checkpoint``, every leaf equal. The codec of flax's msgpack format
round-trips with flax's own on bfloat16, 0-d, empty and chunked leaves.
``Trainer.load`` reads either suffix, in full or for inference.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from stylex_tpu.config import Arch as JArch, ModelConfig as JModelConfig
from stylex_tpu.config import TrainConfig as JTrainConfig
from stylex_tpu.models import build_stylex as j_build_stylex
from stylex_tpu.models.classifiers import build_classifier as j_build_classifier
from stylex_tpu.models.lpips import init_lpips_params as j_init_lpips
from stylex_tpu.train.state import create_train_state as j_create_train_state
from stylex_tpu.train.steps import make_train_step as j_make_train_step
from stylex_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from stylex_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from stylex_tpu_torch.config import Arch, ModelConfig, TrainConfig
from stylex_tpu_torch.models import build_classifier
from stylex_tpu_torch.models.convert import (
    classifier_state_dict_from_jax,
    lpips_params_from_jax,
    stylex_state_dict_from_jax,
    train_state_to_jax,
)
from stylex_tpu_torch.models.stylex import StylEx
from stylex_tpu_torch.train import create_train_state, make_train_step
from stylex_tpu_torch.train.trainer import Trainer
from stylex_tpu_torch.utils import flax_msgpack
from stylex_tpu_torch.utils.checkpoint import (
    checkpoint_path,
    latest_checkpoint,
    load_jax_checkpoint,
    save_checkpoint,
    save_jax_checkpoint,
)

from test_torch_train import GRAD_REL, LOSS_ATOL, LOSS_RTOL, TC, TINY, _np, jax_draws

torch.set_num_threads(2)

CASES = {
    "old_attn_vq": dict(arch="old", attn_layers=(1,), fq_layers=(2,)),
    "new": dict(arch="new"),
}
B1 = 0.5  # the StylEx Adam's first-moment decay


def _flat(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want):
    """Same structure (masked ``{}`` leaves included) and every leaf equal
    in value and dtype."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    g = _flat(got)
    for k, v in _flat(want).items():
        a, b = np.asarray(g[k]), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def _jax_state(case):
    """A JAX train state of ``case`` whose Adam moments, counts (5 for the
    'gen' label, 3 elsewhere), step and pl_mean are all set: moments drawn
    from a seed, second moments in [0.5, 4)."""
    kw = CASES[case]
    jcfg = JModelConfig(**{**TINY, **kw, "arch": JArch(kw["arch"])})
    jtc = JTrainConfig(**TC)
    modules = j_build_stylex(jcfg)
    state, g_tx, d_tx = j_create_train_state(jax.random.PRNGKey(0), modules, jcfg, jtc)
    rng = np.random.RandomState(1)

    def fill(path, x):
        name = jax.tree_util.keystr(path)
        if x.dtype != np.float32:  # the counts
            return np.asarray(5 if "'gen'" in name else 3, x.dtype)
        v = rng.randn(*x.shape).astype(np.float32)
        return (np.abs(v) + 0.5) if "nu" in name else v

    state = state.replace(
        g_opt_state=jax.tree_util.tree_map_with_path(fill, state.g_opt_state),
        d_opt_state=jax.tree_util.tree_map_with_path(fill, state.d_opt_state),
        step=jnp.asarray(7, jnp.int32), pl_mean=jnp.asarray(0.5, jnp.float32))
    return dict(jcfg=jcfg, jtc=jtc, modules=modules, state=state, g_tx=g_tx, d_tx=d_tx)


@pytest.fixture(scope="module", params=sorted(CASES))
def saved(request, tmp_path_factory):
    j = _jax_state(request.param)
    models = tmp_path_factory.mktemp(request.param)
    path = j_save_checkpoint(str(models), "m", 1, j["state"], extra={"version": "jax"})
    kw = CASES[request.param]
    cfg = ModelConfig(**{**TINY, **kw, "arch": Arch(kw["arch"])})
    (models / "m" / ".config.json").write_text(j["jcfg"].to_json())
    return dict(j, case=request.param, path=path, models=models, cfg=cfg)


def _port_state(saved):
    state = create_train_state(StylEx(saved["cfg"]), saved["cfg"], TrainConfig(**TC))
    load_jax_checkpoint(saved["path"], state)
    return state


def test_jax_checkpoint_restores_leaf_for_leaf(saved):
    state = _port_state(saved)
    _assert_trees_equal(train_state_to_jax(state), serialization.to_state_dict(saved["state"]))
    # the forward map alone: parameters, buffers, counts and moments in place
    cfg, js = saved["cfg"], saved["state"]
    want = stylex_state_dict_from_jax(_np(js.full_params()), cfg)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert state.step == 7 and float(state.pl_mean) == 0.5
    steps = {float(s["step"]) for s in state.g_opt.state.values()}
    assert steps == ({3.0, 5.0} if cfg.arch == Arch.NEW else {3.0})
    assert len(state.g_opt.state) == sum(1 for n in ("encoder", "S", "G")
                                         for _ in getattr(state.model, n).parameters())


def test_port_jax_checkpoint_restored_by_jax(saved, tmp_path):
    state = _port_state(saved)
    path = save_jax_checkpoint(str(tmp_path), "m", 3, state)
    assert path.endswith("model_3.ckpt")
    back = j_load_checkpoint(path, saved["state"])
    _assert_trees_equal(serialization.to_state_dict(back),
                        serialization.to_state_dict(saved["state"]))


def test_train_step_from_jax_checkpoint_matches_jax(saved, monkeypatch):
    """One step with the real Adam of both packages from the same file:
    losses, the gradients implied by the first moments, the parameter
    updates (dominated by the restored moments and counts) and the EMA."""
    monkeypatch.setenv("STYLEX_TPU_NO_FUSED_UPCONV", "1")
    jcfg, jtc, modules = saved["jcfg"], saved["jtc"], saved["modules"]
    jclf = j_build_classifier("mobilenet", jcfg.image_size)
    jlp = j_init_lpips(jax.random.PRNGKey(1))
    jstep = jax.jit(j_make_train_step(modules, jclf.classify_images, jlp, jcfg, jtc,
                                      saved["g_tx"], saved["d_tx"]))
    jstate = j_load_checkpoint(saved["path"], saved["state"])
    rng = np.random.RandomState(3)
    batch = {k: rng.rand(2, 2, 16, 16, 3).astype(np.float32) for k in ("d_real", "d_enc", "g_imgs")}
    key = jax.random.PRNGKey(11)
    new_j, metrics_j = jstep(jstate, batch, key)

    cfg, tc = saved["cfg"], TrainConfig(**TC)
    state = _port_state(saved)
    clf = build_classifier("mobilenet", cfg.image_size, device="cpu")
    clf.net.load_state_dict(classifier_state_dict_from_jax(_np(jclf.variables), "mobilenet"))
    clf.net.requires_grad_(False)
    step = make_train_step(cfg, tc, clf.classify_images, lpips_params_from_jax(_np(jlp)))
    draws = jax_draws(key, jcfg, jtc, modules.num_layers)
    draws = draws._replace(g=draws.g._replace(pl_noise=None))  # step 7: no PL
    metrics = step(state, batch, draws)
    assert state.step == 8
    for k, v in metrics_j.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=f"metric {k}")

    old = _flat(serialization.to_state_dict(jstate))
    new = _flat(serialization.to_state_dict(new_j))
    got = _flat(train_state_to_jax(state))
    grads, moments = {}, {}
    for k in new:
        if "['mu']" in k:  # gradient = (mu_new - b1 mu_old) / (1 - b1)
            tree = "D" if k.startswith("['d_opt_state']") else k.split("['mu']['")[1].split("'")[0]
            g_j = (np.asarray(new[k]) - B1 * np.asarray(old[k])) / (1 - B1)
            g_p = (np.asarray(got[k]) - B1 * np.asarray(old[k])) / (1 - B1)
            grads.setdefault(tree, []).append((k, g_p, g_j))
            count = int(np.asarray(new[k.split("['mu']")[0] + "['count']"]))
            param = "['params']" + ("['D']" if tree == "D" else "") + k.split("['mu']")[1]
            moments[param] = (k, k.replace("['mu']", "['nu']"), count, tree)
        elif "['ema_params']" in k or "_vq'" in k:
            np.testing.assert_allclose(got[k], new[k], rtol=1e-4, atol=1e-5, err_msg=k)
        elif "count" in k or "step" in k:
            assert np.array_equal(got[k], new[k]), k
    assert set(grads) == {"encoder", "S", "G", "D"}
    delta = {}
    for tree, items in grads.items():
        scale = max(float(np.abs(w).max()) for _, _, w in items)
        delta[tree] = GRAD_REL * scale + 1e-12
        for k, g, w in items:
            np.testing.assert_allclose(g, w, rtol=0, atol=delta[tree],
                                       err_msg=f"gradient {k} (tree max {scale:.3g})")
    # the second moments agree as far as the gradients do:
    # |d nu| <= (1 - b2) (2 |g| + d) d
    for k, (mu_k, nu_k, count, tree) in moments.items():
        g = np.abs((np.asarray(new[mu_k]) - B1 * np.asarray(old[mu_k])) / (1 - B1))
        d = delta[tree]
        err = np.abs(np.asarray(got[nu_k]) - np.asarray(new[nu_k]))
        assert (err <= 1e-6 * np.abs(np.asarray(new[nu_k])) + 0.1 * (2 * g + d) * d).all(), nu_k
    # each package's update is Adam's, from its own moments, with the tree's
    # learning rate and the label's count: the restored counts and moments
    # are the ones the step used
    lrs = {"D": tc.lr * tc.ttur_mult, "S": tc.lr, "G": tc.lr,
           "encoder": 1e-5 if cfg.arch == Arch.NEW else tc.lr}
    assert len(moments) == sum(1 for k in new if k.startswith("['params']") and "_vq'" not in k)
    for k, (mu_k, nu_k, count, tree) in moments.items():
        for tag, mine in (("port", got), ("jax", new)):
            m = np.asarray(mine[mu_k], np.float64) / (1 - B1 ** count)
            v = np.asarray(mine[nu_k], np.float64) / (1 - 0.9 ** count)
            want = -lrs[tree] * m / (np.sqrt(v) + 1e-8)
            # p + update is rounded to float32: one ulp of |p| on top
            err = np.abs(np.asarray(mine[k], np.float64) - np.asarray(old[k]) - want)
            ulp = 2.0 ** -23 * np.abs(np.asarray(old[k], np.float64))
            assert (err <= 1e-5 * np.abs(want) + 2 * ulp + 1e-12).all(), f"{tag} update {k}"


def _trainer(models, cfg=None, **kw):
    return Trainer(name="m", base_dir=str(models), models_dir=".", model_cfg=cfg,
                   train_cfg=TrainConfig(**TC, save_every=100), classifier_name="mobilenet",
                   device="cpu", **kw)


def test_trainer_loads_jax_checkpoint_full_and_for_inference(saved):
    trainer = _trainer(saved["models"])
    trainer.load(1)
    assert trainer.model_cfg == saved["cfg"]  # from the JAX package's .config.json
    want = _port_state(saved)
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(v, want.model.state_dict()[k]), k
    assert trainer.steps == 7 and len(trainer.state.d_opt.state) > 0

    trainer.set_data_src(dataset_name="synthetic")
    try:
        trainer.load(-1, inference=True, ship_ema=False, param_dtype=torch.bfloat16)
        model = trainer.state.model
        assert trainer.steps == 7
        assert not trainer.state.g_opt.state and not trainer.state.d_opt.state
        for name in ("encoder", "S", "G", "D"):
            sd = getattr(model, name).state_dict()
            assert all(v.dtype == torch.bfloat16 for v in sd.values() if v.is_floating_point())
        for name in ("SE", "GE"):  # kept as stored: float32, on the host
            for k, v in getattr(model, name).state_dict().items():
                assert v.dtype == torch.float32 and torch.equal(v, want.model.state_dict()[
                    f"{name}.{k}"])
        w = want.model.state_dict()
        for k, v in model.state_dict().items():
            if not k.startswith(("SE.", "GE.")):
                assert torch.equal(v, w[k].to(v.dtype)), k
        with pytest.raises(RuntimeError, match="inference=True"):
            trainer.train()
        trainer.load(1)  # a full load makes the trainer train again
        assert len(trainer.state.g_opt.state) > 0
        assert all(p.dtype == torch.float32 for p in trainer.state.model.parameters())
    finally:
        trainer.close()


def test_stored_step_zero_counts_from_num(tmp_path):
    cfg = ModelConfig(**TINY)
    trainer = _trainer(tmp_path, cfg)
    trainer.init_stylex()
    save_jax_checkpoint(str(tmp_path), "m", 4, trainer.state)  # step 0
    for inference in (False, True):
        fresh = _trainer(tmp_path, cfg)
        fresh.load(4, inference=inference)
        assert fresh.steps == 4 * 100
        fresh.close()
    trainer.close()


def test_latest_checkpoint_takes_either_suffix_and_prefers_pt_on_a_tie(tmp_path):
    cfg = ModelConfig(**TINY)
    state = create_train_state(StylEx(cfg), cfg, TrainConfig())
    assert latest_checkpoint(str(tmp_path), "m") is None
    save_checkpoint(str(tmp_path), "m", 2, state)
    save_jax_checkpoint(str(tmp_path), "m", 3, state)
    assert latest_checkpoint(str(tmp_path), "m") == (3, str(checkpoint_path(str(tmp_path), "m",
                                                                            3, ".ckpt")))
    save_checkpoint(str(tmp_path), "m", 3, state)
    assert latest_checkpoint(str(tmp_path), "m") == (3, str(checkpoint_path(str(tmp_path), "m",
                                                                            3)))
    (tmp_path / "m" / "model_10.ckpt.tmp").write_bytes(b"")  # a half-written file does not count
    assert latest_checkpoint(str(tmp_path), "m")[0] == 3


# ------------------------------------------------------------------- codec

def _leaves():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "zero_d": np.asarray(7, np.int32),
        "empty": np.zeros((0, 5), np.float32),
        "bf16": jnp.asarray(rng.randn(5, 3), jnp.bfloat16),
        "u8": rng.randint(0, 255, (2, 2, 3)).astype(np.uint8),
        "f64": rng.randn(6),
        "bool": np.array([True, False]),
        "scalar": np.float32(1.5),
        "nested": {"masked": {}, "i": -3, "big": 2 ** 40, "s": "text", "x": 0.25, "n": None},
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif torch.is_tensor(got):  # bfloat16 leaves come back as torch tensors
        w = np.asarray(want)
        assert str(w.dtype) == "bfloat16" and got.dtype == torch.bfloat16
        assert got.shape == w.shape
        assert np.array_equal(got.view(torch.int16).numpy(), w.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
        w, g = np.asarray(want), np.asarray(got)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    else:
        assert got == want and type(got) is type(want)


def test_codec_round_trips_with_flax():
    tree = _leaves()
    blob = serialization.msgpack_serialize(tree)
    got = flax_msgpack.msgpack_restore(blob)
    _assert_same(got, tree)
    assert flax_msgpack.msgpack_serialize(got) == blob  # byte for byte as flax writes it
    _assert_same(serialization.msgpack_restore(flax_msgpack.msgpack_serialize(got)), tree)


def test_codec_chunks_large_leaves_as_flax_does(monkeypatch, tmp_path):
    import flax.serialization as fs

    tree = {"big": np.arange(1000, dtype=np.float32).reshape(10, 100),
            "bf": jnp.asarray(np.linspace(-3, 3, 300).reshape(3, 100), jnp.bfloat16),
            "small": np.ones(3, np.float32)}
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 256)
    blob = fs.msgpack_serialize(tree)
    mine = flax_msgpack.msgpack_serialize(flax_msgpack.msgpack_restore(blob))
    assert mine == blob
    _assert_same(flax_msgpack.msgpack_restore(blob), tree)
    path = tmp_path / "t.msgpack"
    flax_msgpack.dump(flax_msgpack.msgpack_restore(blob), path)
    _assert_same(fs.msgpack_restore(path.read_bytes()), tree)
    _assert_same(flax_msgpack.load(path), tree)


def test_codec_leaves_view_the_file_buffer(tmp_path):
    path = tmp_path / "t.msgpack"
    tree = {"a": np.arange(6, dtype=np.float32), "b": torch.ones(4, dtype=torch.bfloat16)}
    flax_msgpack.dump(tree, path)
    got = flax_msgpack.load(path)
    assert got["a"].base is not None and got["a"].flags.writeable  # a view, no copy
    # the bfloat16 leaf views the same buffer
    assert abs(got["b"].data_ptr() - got["a"].ctypes.data) < path.stat().st_size
    with pytest.raises(FileNotFoundError):
        flax_msgpack.load(tmp_path / "missing.msgpack")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(path.read_bytes()[:-3])
    with pytest.raises(TypeError):
        flax_msgpack.msgpack_serialize({"x": object()})
