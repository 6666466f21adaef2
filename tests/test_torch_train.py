"""The port's training against the JAX package's, on the CPU.

One whole train step of the port is held against ``make_train_step`` (the
fused-microbatch step, literal resample graph) for the OLD and NEW archs,
on a step with both the gradient penalty and the path-length penalty on and
one with neither, from the same weights, batch and random draws. The JAX
draws are rebuilt by replaying the step's key chain (:func:`jax_draws`).

To read gradients, both steps run with an optimizer that adds the gradient
(``optax.scale(1.0)`` on the JAX side): new - old params = gradients, of D
on the D phase and of encoder/S/G on the G phase, which runs on the updated
D in both. Losses match at rtol 1e-4 / atol 1e-5 and gradients at atol
1e-4 x max|g| per tree: float32 convolutions and reductions sum in other
orders, and second-order terms amplify that.

Also: Adam against optax's on identical gradients (1e-6), the JAX train
state's Adam moments carried into the port, the Trainer (two steps on
synthetic data, a checkpoint round trip, NaN -> reload -> NanException) and
the CLI.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from stylex_tpu.config import Arch as JArch, ModelConfig as JModelConfig
from stylex_tpu.config import TrainConfig as JTrainConfig
from stylex_tpu.models import build_stylex as j_build_stylex
from stylex_tpu.models.classifiers import build_classifier as j_build_classifier
from stylex_tpu.models.lpips import init_lpips_params as j_init_lpips
from stylex_tpu.ops.latents import image_noise as j_image_noise
from stylex_tpu.train.state import create_train_state as j_create_train_state
from stylex_tpu.train.steps import make_train_step as j_make_train_step
from stylex_tpu_torch.config import Arch, ModelConfig, TrainConfig
from stylex_tpu_torch.models import build_classifier
from stylex_tpu_torch.models.convert import (
    classifier_state_dict_from_jax,
    lpips_params_from_jax,
    stylex_state_dict_from_jax,
    train_state_from_jax,
)
from stylex_tpu_torch.models.stylex import StylEx
from stylex_tpu_torch.ops import diffaug as taug
from stylex_tpu_torch.train import PhaseDraws, StepDraws, create_train_state, make_train_step

from test_torch_diffaug import jax_draws as jax_aug_draws, jax_pipeline_draws

torch.set_num_threads(2)

TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)
# GP at step 0 (gp_every 4), PL at even steps, EMA every step
TC = dict(batch_size=2, gradient_accumulate_every=2, aug_prob=0.0, pl_start_step=-1,
          pl_every=2, ema_start_step=-1, ema_every=1)
TREES = ("encoder", "S", "G", "D")
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
GRAD_REL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cat_aug(parts):
    """Concatenate per-micro-batch AugmentDraws into one over all samples."""
    return taug.AugmentDraws(
        torch.cat([p.gate for p in parts]), torch.cat([p.flip for p in parts]),
        tuple(tuple(None if a[0] is None else torch.cat(a) for a in zip(*ops))
              for ops in zip(*(p.ops for p in parts))))


def jax_draws(rng, jcfg, jtc, num_layers):
    """The draws of one JAX train step from its key ``rng``: the step's
    2-way split, each phase's per-micro-batch key chain (7-way in the D
    phase, 6-way in the G phase), the 4-way split of ``sample_prior_w``,
    ``image_noise`` and the DiffAugment keys, as the port's
    :class:`StepDraws`."""
    A, B, S = jtc.gradient_accumulate_every, jtc.batch_size, jcfg.image_size
    prior = [i for i in range(A) if jtc.alternating_training and i % 2 == 0]
    prob = jtc.aug_prob or 0.0

    def chain(key, n):
        keys = []
        for _ in range(A):
            parts = jax.random.split(key, n)
            key = parts[0]
            keys.append(parts[1:])
        return keys

    def aug(keys, j):
        if prob == 0.0:
            return None
        return _cat_aug([jax_aug_draws(keys[i][j], B, S, prob, jtc.aug_types) for i in range(A)])

    def phase(keys, with_pl):
        z1, z2, mixed, cutoff = [], [], [], []
        for i in prior:
            kz1, kz2, kmix, kcut = jax.random.split(keys[i][0], 4)
            z1.append(jax.random.normal(kz1, (B, jcfg.mapping_dim)))
            z2.append(jax.random.normal(kz2, (B, jcfg.mapping_dim)))
            mixed.append(jax.random.bernoulli(kmix, jtc.mixed_prob))
            cutoff.append(jax.random.randint(kcut, (), 0, num_layers))
        noise = [j_image_noise(keys[i][1], B, S) for i in range(A)]
        pl = None
        if with_pl:
            pl = np.stack([np.asarray(jax.random.normal(keys[i][4], (B, S, S, 3)))
                           for i in range(A)]).transpose(0, 1, 4, 2, 3)

        def t(xs, dt=torch.float32, shape=()):
            if not xs:
                return torch.zeros((0,) + shape, dtype=dt)
            return torch.from_numpy(np.stack([np.array(x) for x in xs])).to(dt)

        return PhaseDraws(t(z1, shape=(B, jcfg.mapping_dim)), t(z2, shape=(B, jcfg.mapping_dim)),
                          t(mixed, torch.bool), t(cutoff, torch.int64), t(noise),
                          aug(keys, 2), aug(keys, 3),
                          None if pl is None else torch.from_numpy(pl.copy()),
                          views(keys, 4) if jtc.cl_reg and not with_pl else None)

    def views(keys, j):
        """``contrastive_views``' draws (key split 4-way: ops and flip of
        view 1, then of view 2) of every micro-batch."""
        parts = [jax.random.split(keys[i][j], 4) for i in range(A)]

        def view(k_ops, k_flip):
            return _cat_aug([taug.AugmentDraws(
                torch.ones(B, dtype=torch.bool),
                torch.full((B,), bool(jax.random.bernoulli(p[k_flip], 0.5))),
                jax_pipeline_draws(p[k_ops], B, S, ("translation", "cutout"))) for p in parts])

        return view(0, 1), view(2, 3)

    rng_d, rng_g = jax.random.split(rng)
    return StepDraws(phase(chain(rng_d, 7), False), phase(chain(rng_g, 6), True))


class _AddGrad(torch.optim.Optimizer):
    """p <- p + grad: the port's counterpart of ``optax.scale(1.0)``."""

    def __init__(self, params):
        super().__init__(params, {})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                p.add_(p.grad)


def _setup(arch, model=None, **overrides):
    """The JAX step and the port's at the TINY config of ``arch`` with
    ``model`` (ModelConfig fields) and ``overrides`` (TrainConfig fields)."""
    tc_kwargs = {**TC, **overrides}
    model_kwargs = {**TINY, **(model or {})}
    jcfg = JModelConfig(arch=JArch(arch), **model_kwargs)
    jtc = JTrainConfig(**tc_kwargs)
    modules = j_build_stylex(jcfg)
    state, _, _ = j_create_train_state(jax.random.PRNGKey(0), modules, jcfg, jtc)
    jclf = j_build_classifier("mobilenet", jcfg.image_size)
    jlp = j_init_lpips(jax.random.PRNGKey(1))
    add = optax.scale(1.0)
    jstep = jax.jit(j_make_train_step(modules, jclf.classify_images, jlp, jcfg, jtc, add, add))
    state = state.replace(g_opt_state=add.init(None), d_opt_state=add.init(None))

    cfg, tc = ModelConfig(arch=Arch(arch), **model_kwargs), TrainConfig(**tc_kwargs)
    clf = build_classifier("mobilenet", cfg.image_size, device="cpu")
    clf.net.load_state_dict(classifier_state_dict_from_jax(_np(jclf.variables), "mobilenet"))
    clf.net.requires_grad_(False)
    lp = lpips_params_from_jax(_np(jlp))
    step = make_train_step(cfg, tc, clf.classify_images, lp)
    rng = np.random.RandomState(3)
    batch = {k: rng.rand(2, 2, 16, 16, 3).astype(np.float32)
             for k in ("d_real", "d_enc", "g_imgs", "g_real")}
    if tc.top_k_training:
        batch["top_k"] = 1
    return dict(jcfg=jcfg, jtc=jtc, modules=modules, state=state, jstep=jstep, cfg=cfg, tc=tc,
                step=step, batch=batch, clf=clf, lpips=lp)


@pytest.fixture(scope="module", params=["old", "new"])
def pair(request, monkeypatch_module):
    monkeypatch_module.setenv("STYLEX_TPU_NO_FUSED_UPCONV", "1")
    return _setup(request.param)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _port_state(p, jstate):
    cfg, tc = p["cfg"], p["tc"]
    model = StylEx(cfg)
    model.load_state_dict(stylex_state_dict_from_jax(_np(jstate.full_params()), cfg))
    state = create_train_state(model, cfg, tc)
    state.g_opt = _AddGrad(state.g_opt.param_groups[0]["params"]
                           + sum((g["params"] for g in state.g_opt.param_groups[1:]), []))
    state.d_opt = _AddGrad(list(model.D.parameters()))
    state.step = int(jstate.step)
    state.pl_mean = torch.tensor(float(jstate.pl_mean))
    return state


def _assert_trees_close(got_sd, want_sd, names, what):
    for name in names:
        # the quantize layers' codebooks are buffers: compare_step holds them
        keys = [k for k in want_sd if k.startswith(name + ".") and ".quantize_blocks." not in k]
        scale = max(float(np.abs(want_sd[k].numpy()).max()) for k in keys)
        for k in keys:
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=0,
                                       atol=GRAD_REL * scale + 1e-12,
                                       err_msg=f"{what} {k} (tree max {scale:.3g})")


def compare_step(p, at_step):
    """One port step against the JAX step from the same state, batch and
    key: metrics, gradients per tree and the EMA copies."""
    jstate = p["state"].replace(step=jnp.asarray(at_step, jnp.int32),
                                pl_mean=jnp.asarray(0.5, jnp.float32))
    key = jax.random.PRNGKey(11 + at_step)
    jbatch = {k: (jnp.asarray(v, jnp.int32) if k == "top_k" else v)
              for k, v in p["batch"].items() if k != "g_real" or p["tc"].dual_contrast_loss}
    new_j, metrics_j = p["jstep"](jstate, jbatch, key)

    state = _port_state(p, jstate)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    draws = jax_draws(key, p["jcfg"], p["jtc"], p["modules"].num_layers)
    if at_step % p["tc"].pl_every != 0:
        draws = draws._replace(g=draws.g._replace(pl_noise=None))
    metrics = p["step"](state, p["batch"], draws)

    assert state.step == at_step + 1
    for k, v in metrics_j.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=f"metric {k}")
    cfg = p["cfg"]
    old_j = stylex_state_dict_from_jax(_np(jstate.full_params()), cfg)
    new_j_sd = stylex_state_dict_from_jax(_np(new_j.full_params()), cfg)
    after = state.model.state_dict()
    grads_j = {k: new_j_sd[k] - old_j[k] for k in new_j_sd}
    grads = {k: after[k] - before[k] for k in after}
    _assert_trees_close(grads, grads_j, TREES, "gradient")
    for k in new_j_sd:  # codebooks after their EMA update
        if ".quantize_blocks." in k:
            np.testing.assert_allclose(after[k].numpy(), new_j_sd[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    # EMA copies after the step (EMA every step, beta 0.995) take 0.005 of
    # the live weights, whose updates agree to the gradient tolerance
    for ema, live in (("SE", "S"), ("GE", "G")):
        scale = max(float(np.abs(grads_j[k].numpy()).max()) for k in grads_j
                    if k.startswith(live + "."))
        for k in new_j_sd:
            if k.startswith(ema + "."):
                np.testing.assert_allclose(after[k].numpy(), new_j_sd[k].numpy(), rtol=0,
                                           atol=0.005 * GRAD_REL * scale + 1e-6, err_msg=k)
    return metrics


@pytest.mark.parametrize("at_step", [0, 1])
def test_train_step_matches_jax(pair, at_step):
    """Step 0 runs GP and PL (pl_mean 0.5, so the penalty is live) and an
    EMA update; step 1 runs neither penalty."""
    metrics = compare_step(pair, at_step)
    if at_step == 0:
        assert float(metrics["gp"]) > 0 and float(metrics["pl_mean"]) != 0.5


def test_float64_witness_step_matches_jax(pair):
    """``compute_dtype='float64'`` (float64 copies of the float32 weights, a
    float64 classifier) is the witness that float32 rounding is measured
    against: it matches the JAX float32 step, GP and PL on, and it really
    computes in float64, so its losses differ from the port's float32
    step's in the last bits."""
    import copy
    import dataclasses

    clf64 = copy.deepcopy(pair["clf"]).to(torch.float64)
    tc64 = dataclasses.replace(pair["tc"], compute_dtype="float64")
    step64 = make_train_step(pair["cfg"], tc64, clf64.classify_images, pair["lpips"])
    m64 = compare_step({**pair, "step": step64}, 0)
    assert all(v.dtype == torch.float64 for k, v in m64.items() if k != "pl_mean")
    m32 = compare_step(pair, 0)
    assert any(float(m64[k]) != float(m32[k]) for k in ("d_loss", "g_loss", "rec_loss"))


@pytest.mark.parametrize("arch", ["old", "new"])
def test_adam_matches_optax_and_carries_over(arch):
    """Three updates of the port's optimizers against optax's make_optimizers
    on identical gradients (1e-6), then the JAX state's Adam moments carried
    into the port by train_state_from_jax reproduce a fourth update."""
    from stylex_tpu.models import init_stylex_params
    from stylex_tpu.train.state import make_optimizers as j_make_optimizers

    jcfg = JModelConfig(arch=JArch(arch), **TINY)
    jtc = JTrainConfig(**TC)
    modules = j_build_stylex(jcfg)
    params = init_stylex_params(jax.random.PRNGKey(0), modules)
    g_tx, d_tx = j_make_optimizers(jcfg, jtc)
    gsub = {k: params[k] for k in ("encoder", "S", "G")}
    g_state, d_state, d_params = g_tx.init(gsub), d_tx.init(params["D"]), params["D"]

    cfg, tc = ModelConfig(arch=Arch(arch), **TINY), TrainConfig(**TC)
    model = StylEx(cfg)
    model.load_state_dict(stylex_state_dict_from_jax(_np(params), cfg))
    state = create_train_state(model, cfg, tc)
    rng = np.random.RandomState(0)

    def rand_like(tree):
        return jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)), tree)

    def port_step(st, g_grads, d_grads):
        sd = stylex_state_dict_from_jax(_np({**g_grads, "D": d_grads, "SE": params["SE"],
                                             "GE": params["GE"]}), cfg)
        named = dict(st.model.named_parameters())
        for name in TREES:
            for k, prm in named.items():
                if k.startswith(name + "."):
                    prm.grad = sd[k].clone()
        st.g_opt.step()
        st.d_opt.step()

    for i in range(4):
        g_grads, d_grads = rand_like(gsub), rand_like(d_params)
        upd, g_state = g_tx.update(g_grads, g_state, gsub)
        gsub = optax.apply_updates(gsub, upd)
        upd, d_state = d_tx.update(d_grads, d_state, d_params)
        d_params = optax.apply_updates(d_params, upd)
        port_step(state, g_grads, d_grads)
        if i == 2:  # carry the JAX state over before the last update
            jstate = type("S", (), dict(params={**gsub, "D": d_params},
                                        ema_params={"SE": params["SE"], "GE": params["GE"]},
                                        g_opt_state=g_state, d_opt_state=d_state,
                                        step=3, pl_mean=-1.0))
            carried = train_state_from_jax(jstate, cfg, tc, device="cpu")
        elif i == 3:
            port_step(carried, g_grads, d_grads)
    want = stylex_state_dict_from_jax(_np({**gsub, "D": d_params, "SE": params["SE"],
                                           "GE": params["GE"]}), cfg)
    for st in (state, carried):
        got = st.model.state_dict()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
    assert carried.step == 3 and float(carried.pl_mean) == -1.0


# ------------------------------------------------------------ trainer, CLI


def _trainer(tmp_path, **tc_kwargs):
    from stylex_tpu_torch.train.trainer import Trainer

    tc = TrainConfig(batch_size=2, gradient_accumulate_every=2, aug_prob=0.0, save_every=1000,
                     evaluate_every=1000, num_image_tiles=2, **tc_kwargs)
    return Trainer(name="t", base_dir=str(tmp_path), model_cfg=ModelConfig(**TINY),
                   train_cfg=tc, classifier_name="mobilenet", device="cpu")


def test_trainer_steps_saves_and_reloads(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.set_data_src(dataset_name="synthetic")
    try:
        trainer.init_stylex()
        g0 = trainer.state.model.G.initial_conv.weight.detach().clone()
        for _ in range(2):
            metrics = trainer.train()
        assert trainer.steps == 2
        assert all(math.isfinite(metrics[k]) for k in ("d_loss", "g_loss", "gp", "rec_loss"))
        assert not torch.equal(g0, trainer.state.model.G.initial_conv.weight)
        path = trainer.save(7)
        assert (tmp_path / "models" / "t" / ".config.json").exists()
        saved = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
        adam = trainer.state.d_opt.state_dict()["state"][0]["exp_avg"].clone()
        trainer.train()
        trainer.load(-1)
        assert trainer.steps == 2 and path.endswith("model_7.pt")
        for k, v in trainer.state.model.state_dict().items():
            assert torch.equal(v, saved[k]), k
        assert torch.equal(trainer.state.d_opt.state_dict()["state"][0]["exp_avg"], adam)
        trainer.evaluate(num=0)
        out = tmp_path / "results" / "t"
        assert {"0.png", "0-ema.png", "0-from_encoder.png", "0-from_encoder-ema.png"} <= {
            f.name for f in out.iterdir()}
        assert (out / "metrics.csv").read_text().count("\n") == 4  # header + 3 steps
    finally:
        trainer.close()


def test_trainer_nan_reloads_then_raises(tmp_path):
    from stylex_tpu_torch.train.trainer import NanException

    trainer = _trainer(tmp_path)
    trainer.set_data_src(dataset_name="synthetic")
    try:
        trainer.train()
        trainer.save(0)
        saved = trainer.state.model.G.initial_conv.weight.detach().clone()
        with torch.no_grad():
            trainer.state.model.D.fc.bias.fill_(float("nan"))
        with pytest.raises(NanException):
            trainer.train()
        assert trainer.steps == 1
        assert torch.equal(trainer.state.model.G.initial_conv.weight, saved)
        assert torch.isfinite(trainer.state.model.D.fc.bias).all()
    finally:
        trainer.close()


def test_cli_trains_at_tiny_config_on_cpu(tmp_path, capsys):
    from stylex_tpu_torch import cli

    cli.main(["--dataset-name", "synthetic", "--device", "cpu", "--image-size", "16",
              "--network-capacity", "4", "--batch-size", "2", "--gradient-accumulate-every", "2",
              "--num-train-steps", "2", "--save-every", "1000", "--evaluate-every", "1000",
              "--classifier-name", "mobilenet", "--aug-prob", "0.0", "--num-image-tiles", "2",
              "--name", "c", "--results-dir", str(tmp_path / "r"),
              "--models-dir", str(tmp_path / "m")])
    assert (tmp_path / "m" / "c" / "model_0.pt").exists()
    cfg = json.loads((tmp_path / "m" / "c" / ".config.json").read_text())
    assert cfg["image_size"] == 16 and cfg["latent_dim"] == 514
    # the contrastive regulariser trains and logs its loss
    cli.main(["--dataset-name", "synthetic", "--device", "cpu", "--cl-reg", "True",
              "--image-size", "16", "--network-capacity", "4", "--batch-size", "2",
              "--gradient-accumulate-every", "2", "--num-train-steps", "1",
              "--save-every", "1000", "--evaluate-every", "1000", "--num-image-tiles", "2",
              "--classifier-name", "mobilenet", "--aug-prob", "0.0", "--name", "c2",
              "--models-dir", str(tmp_path / "m2"), "--results-dir", str(tmp_path / "r2")])
    header, row = (tmp_path / "r2" / "c2" / "metrics.csv").read_text().splitlines()[:2]
    cr = float(row.split(",")[header.split(",").index("cr_loss")])
    assert math.isfinite(cr) and cr > 0
    with pytest.raises(SystemExit):
        cli.main(["--no-such-flag", "1"])
