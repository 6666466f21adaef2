"""Data parallelism on host ranks: ``stylex_tpu_torch.parallel`` under gloo,
2 and 4 ranks launched on the CPU, held against one process and against the
JAX package.

At the tiny config of ``tests/test_sharding.py`` (16 px, capacity 4,
latent 34, encoder 32), each rank count runs every case in one launch
(``testing.harness.run``): the mesh helpers, one train step in three
configurations, the AttFind sweep flat and block-resume with a
``coord_batch`` that is not a multiple of the rank count, and three
``Trainer.train()`` steps. The single process runs the same cases in this
process, with no process group.

Tolerances: metrics rtol 2e-3, atol 1e-5 and parameters rtol 2e-3, atol
2e-5 (``tests/test_sharding.py``'s); the step's gradients, which a plain
step (p <- p - lr g) applies and keeps, per tree at 1e-4 x the tree's
largest (``tests/test_torch_train.py``'s gradient tolerance; the ranks sum
float32 gradients in another order), with the step's kinks smoothed
(``harness.smooth_kinks``); sweeps rtol 1e-4, atol 1e-5. The
ranks' states after the Trainer's steps are equal bit for bit, Adam state
included. The world-2 step is also held against the JAX package's
single-device ``make_train_step`` through ``tests/test_torch_train.py``'s
mapping, and the sweeps against the JAX package's sweep sharded over 8
virtual devices.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from stylex_tpu.attfind import attfind_extraction as j_extraction
from stylex_tpu.config import ModelConfig as JModelConfig
from stylex_tpu.models import build_stylex as j_build_stylex
from stylex_tpu.models import init_stylex_params
from stylex_tpu.models.classifiers import build_classifier as j_build_classifier
from stylex_tpu.parallel.mesh import make_mesh as j_make_mesh
from stylex_tpu_torch.config import Arch, ModelConfig, TrainConfig
from stylex_tpu_torch.models import build_stylex
from stylex_tpu_torch.models.convert import (
    classifier_state_dict_from_jax,
    stylex_state_dict_from_jax,
)
from stylex_tpu_torch.models.lpips import init_lpips_params
from stylex_tpu_torch.parallel import (
    Mesh,
    data_sharding,
    gather,
    launch,
    make_mesh,
    resolve_num_devices,
)
from stylex_tpu_torch.testing import harness
from stylex_tpu_torch.train import draw_step

from test_torch_train import GRAD_REL, _port_state, _setup, compare_step, jax_draws

torch.set_num_threads(2)

TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)
METRIC_RTOL, METRIC_ATOL = 2e-3, 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5
SWEEP_RTOL, SWEEP_ATOL = 1e-4, 1e-5
WORLDS = (2, 4)
B, A = 4, 2  # every rank count divides B
# GP at step 0, PL at even steps, EMA every step: all on in one step
TC = dict(batch_size=B, gradient_accumulate_every=A, pl_start_step=-1, pl_every=2,
          ema_start_step=-1, ema_every=1)
STEP_CASES = {
    "old-reldisc-topk": (dict(arch=Arch.OLD), dict(rel_disc_loss=True, top_k_training=True)),
    "new-dual-klrec": (dict(arch=Arch.NEW), dict(dual_contrast_loss=True,
                                                 kl_rec_during_disc=True)),
    "old-scan-clreg-vq": (dict(arch=Arch.OLD, fq_layers=(2,)),
                          dict(cl_reg=True, fused_microbatches=False)),
}
SWEEPS = {"resume": dict(block_resume=True), "flat": dict(block_resume=False)}
COORD_BATCH = 63  # a multiple of neither rank count
SMOOTH_EPS = 1e-2
FIELDS = ("style_change", "latents", "base_prob", "minima", "maxima", "style_coordinates",
          "discriminator")
needs_8 = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual JAX devices")


def _step_case(model_kw, tc_kw):
    cfg = ModelConfig(**TINY, **model_kw)
    tc = TrainConfig(aug_prob=0.25, **TC, **tc_kw)
    model = build_stylex(cfg, seed=0, device="cpu")
    draws = draw_step(torch.Generator().manual_seed(5), cfg, tc, B, model.num_layers, 0.25, 0)
    rng = np.random.RandomState(3)
    batch = {k: rng.rand(A, B, 16, 16, 3).astype(np.float32)
             for k in ("d_real", "d_enc", "g_imgs", "g_real")}
    if tc.top_k_training:
        batch["top_k"] = 3
    return dict(model_cfg=cfg, train_cfg=tc, state_dict=model.state_dict(), step=0,
                pl_mean=0.5, classifier=("mobilenet", 16, 2, None),
                lpips=init_lpips_params(device="cpu"), batch=batch, draws=draws,
                optimizer=tc.lr)


@pytest.fixture(scope="module")
def jax_sweep():
    """The JAX model, classifier and inputs of the sweeps, and the port's
    copies of the weights."""
    jcfg = JModelConfig(**TINY)
    modules = j_build_stylex(jcfg)
    params = init_stylex_params(jax.random.PRNGKey(0), modules)
    clf_j = j_build_classifier("mobilenet", 16)
    rng = np.random.RandomState(4)
    images = rng.rand(3, 16, 16, 3).astype(np.float32)
    noise = rng.rand(1, 16, 16, 1).astype(np.float32)
    cfg = ModelConfig(**TINY)
    port = dict(model_cfg=cfg,
                state_dict=stylex_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg),
                classifier=("mobilenet", 16, 2, classifier_state_dict_from_jax(
                    jax.tree.map(np.asarray, clf_j.variables), "mobilenet")),
                images=images, noise=noise)
    return (modules, params, clf_j.classify_images), port


@pytest.fixture(scope="module")
def jax_pair():
    """``tests/test_torch_train.py``'s OLD-arch setup (literal resample
    graph), and the world-2 run of its step 0 on the inputs ``compare_step``
    builds (the JAX state at step 0 with pl_mean 0.5, the draws of key 11)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("STYLEX_TPU_NO_FUSED_UPCONV", "1")
    p = _setup("old")
    jstate = p["state"].replace(step=jax.numpy.asarray(0, jax.numpy.int32),
                                pl_mean=jax.numpy.asarray(0.5, jax.numpy.float32))
    draws = jax_draws(jax.random.PRNGKey(11), p["jcfg"], p["jtc"], p["modules"].num_layers)
    case = dict(model_cfg=p["cfg"], train_cfg=p["tc"],
                state_dict=_port_state(p, jstate).model.state_dict(), step=0, pl_mean=0.5,
                classifier=("mobilenet", 16, 2, p["clf"].net.state_dict()), lpips=p["lpips"],
                batch=p["batch"], draws=draws, optimizer=-1.0,
                env={"STYLEX_TPU_NO_FUSED_UPCONV": "1"})
    yield p, case
    mp.undo()


def _cases(jax_sweep, tmp_path_factory, jax_case):
    """{label: (harness case name, inputs)} of one launch."""
    _, sweep = jax_sweep
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 5).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(1).randn(5, 3).astype(np.float32))
    cases = {"mesh": ("mesh", dict(x=x, w=w, sizes=(4, 8, 16), flat_sizes=(1, 5, 63, 64)))}
    for name, kw in STEP_CASES.items():
        cases[name] = ("step", _step_case(*kw))
        cases[name + "-smooth"] = ("step", dict(_step_case(*kw), smooth_kinks=SMOOTH_EPS))
    for name, kw in SWEEPS.items():
        cases[name] = ("sweep", dict(sweep, kwargs=dict(coord_batch=COORD_BATCH, **kw)))
    base = tmp_path_factory.mktemp("trainer")
    tc = TrainConfig(**TC, evaluate_every=2, save_every=2, num_image_tiles=2, num_workers=2)
    cases["trainer"] = ("trainer", dict(steps=3, snapshot_after=0, full_state=True, trainer=dict(
        base_dir=str(base), model_cfg=ModelConfig(**TINY), train_cfg=tc,
        classifier_name="mobilenet", seed=0, tensorboard_dir=None)))
    if jax_case is not None:
        cases["jax"] = ("step", jax_case)
    return cases


@pytest.fixture(scope="module")
def runs(jax_sweep, jax_pair, tmp_path_factory):
    """Every case's results by rank count: one process (a list of one
    rank's results), 2 and 4 ranks (each rank's). The world-2 launch also
    runs the JAX comparison's step."""
    cases = {w: _cases(jax_sweep, tmp_path_factory, jax_pair[1] if w == 2 else None)
             for w in (1,) + WORLDS}
    # the launches run beside each other and beside the single process
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        pending = {w: pool.submit(launch, harness.run, w, "cpu",
                                  args=(list(cases[w].values()),)) for w in WORLDS}
        out = {1: [harness.run(make_mesh(1, "cpu"), list(cases[1].values()))]}
        out.update({w: f.result() for w, f in pending.items()})
    return {w: [dict(zip(cases[w], r)) for r in ranks] for w, ranks in out.items()}




# ------------------------------------------------------------------ helpers


@pytest.mark.parametrize("world", WORLDS)
def test_shardings_are_contiguous_slices(runs, world):
    for rank, res in enumerate(r["mesh"] for r in runs[world]):
        assert res["rank"] == rank
        assert res["data_slices"] == [slice(rank * n // world, (rank + 1) * n // world)
                                      for n in (4, 8, 16)]
        per = [-(-n // world) for n in (1, 5, 63, 64)]
        assert res["coord_slices"] == [slice(rank * p, (rank + 1) * p) for p in per]
    with pytest.raises(ValueError, match="does not split"):
        data_sharding(Mesh(rank=0, world_size=world), 4 * world + 1)


@pytest.mark.parametrize("world", WORLDS)
def test_replicated_takes_rank_zero(runs, world):
    for r in runs[world]:
        assert torch.equal(r["mesh"]["replicated"], torch.ones(3))


@pytest.mark.parametrize("world", WORLDS)
def test_gather_forward_is_exact(runs, world):
    x = np.random.RandomState(0).randn(8, 5).astype(np.float32)
    for r in runs[world]:
        np.testing.assert_array_equal(r["mesh"]["gathered"].numpy(), x)
        np.testing.assert_array_equal(r["mesh"]["gathered_t"].numpy(), x.T)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_backward_matches_autograd(runs, world):
    """Every rank's gradient at its rows is the one process's autograd
    gradient of the same coupling loss there, and the summed weight
    gradient is the one process's."""
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 5).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(1).randn(5, 3).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    loss = (torch.softmax(x @ w, dim=0) ** 2).sum()
    gx, gw = torch.autograd.grad(loss, [x, w])
    per = 8 // world
    for rank, r in enumerate(runs[world]):
        np.testing.assert_allclose(r["mesh"]["grad_x"].numpy(),
                                   gx[rank * per:(rank + 1) * per].numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["mesh"]["grad_w"].numpy(), gw.numpy(), rtol=1e-5, atol=1e-7)
    assert gather(x, None) is x and gather(x, make_mesh(1, "cpu")) is x


# -------------------------------------------------------------------- steps


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_one_process(runs, case, world):
    """On every rank: the metrics and every parameter and buffer after the
    step (EMA copies, codebooks); with the kinks smoothed, the applied
    (rank-summed) gradients per tree. As trained, the step's kinks (leaky
    ReLU, ReLU, max pooling) let the ranks' other float32 summation order
    flip an activation, which moves its tree's gradients by about 1e-4 of
    the largest (seen at this size with 8 micro-batches); with the kinks
    smoothed the step is held element by element."""
    want, want_smooth = runs[1][0][case], runs[1][0][case + "-smooth"]
    for rank, ranks in enumerate(runs[world]):
        res, smooth = ranks[case], ranks[case + "-smooth"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                       err_msg=f"rank {rank} metric {k}")
        assert res["step"] == 1
        for k, v in want["state_dict"].items():
            np.testing.assert_allclose(res["state_dict"][k].numpy(), v.numpy(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=f"rank {rank} {k}")
        for tree in ("encoder", "S", "G", "D"):
            keys = [k for k in want_smooth["grads"] if k.startswith(tree + ".")]
            scale = max(float(want_smooth["grads"][k].abs().max()) for k in keys)
            worst = max(float((smooth["grads"][k] - want_smooth["grads"][k]).abs().max())
                        for k in keys)
            assert worst <= GRAD_REL * scale, (rank, tree, worst, scale)


def test_world_two_step_matches_jax(jax_pair, runs):
    """The JAX package's single-device step (optax.scale(1.0), literal
    graph) against the world-2 step on the same state, batch and draws:
    ``compare_step``'s metrics, gradients per tree, codebooks and EMA
    copies."""
    p, case = jax_pair
    res = runs[2][0]["jax"]
    other = runs[2][1]["jax"]
    assert all(torch.equal(other["state_dict"][k], v) for k, v in res["state_dict"].items())

    def world_two(state, batch, draws):
        assert batch is p["batch"]
        for got, want in zip(jax.tree.leaves(draws), jax.tree.leaves(case["draws"])):
            assert torch.equal(got, want)
        state.model.load_state_dict(res["state_dict"])
        state.step, state.pl_mean = res["step"], torch.tensor(res["pl_mean"])
        return {k: torch.tensor(v) for k, v in res["metrics"].items()}

    metrics = compare_step(dict(p, step=world_two), 0)
    assert float(metrics["gp"]) > 0 and float(metrics["pl_mean"]) != 0.5


# ------------------------------------------------------------------- sweeps


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sweep", list(SWEEPS))
def test_sweep_matches_one_process(runs, sweep, world):
    want = runs[1][0][sweep]
    assert want["style_change"].shape[0] == 3
    for rank, ranks in enumerate(runs[world]):
        got = ranks[sweep]
        for f in FIELDS:
            np.testing.assert_allclose(got[f], want[f], rtol=SWEEP_RTOL, atol=SWEEP_ATOL,
                                       err_msg=f"rank {rank} {f}")
            # every rank returns the same records
            np.testing.assert_array_equal(got[f], runs[world][0][sweep][f])


@pytest.fixture(scope="module")
def jax_sharded_records(jax_sweep):
    (modules, params, clf_j), port = jax_sweep
    return j_extraction(modules, params, clf_j, port["images"], port["noise"], coord_batch=64,
                        mesh=j_make_mesh(8), progress=False)


@needs_8
@pytest.mark.parametrize("world", WORLDS)
def test_sweep_matches_jax_sharded_sweep(jax_sharded_records, runs, world):
    want = jax_sharded_records
    for sweep in SWEEPS:
        got = runs[world][0][sweep]
        for f in FIELDS:
            np.testing.assert_allclose(got[f], getattr(want, f), rtol=SWEEP_RTOL,
                                       atol=SWEEP_ATOL, err_msg=f"{sweep} {f}")


# ------------------------------------------------------------------ trainer


@pytest.mark.parametrize("world", WORLDS)
def test_trainer_ranks_stay_bit_equal(runs, world):
    """After 3 ``Trainer.train()`` steps (GP, PL and EMA updates; saves and
    sample grids from the loader's stream at steps 0 and 2): every rank's
    parameters, buffers, Adam moments and counts, EMA copies and
    ``pl_mean`` equal rank 0's bit for bit, the logged metrics are equal on
    every rank, and step 0 (from the same weights and draws) matches the
    single process's: its metrics and its D phase's gradients."""
    ranks = [r["trainer"] for r in runs[world]]
    for r in ranks[1:]:
        assert r["state"].keys() == ranks[0]["state"].keys()
        for k, v in ranks[0]["state"].items():
            assert torch.equal(r["state"][k], v), k
        assert r["metrics"] == ranks[0]["metrics"]
    assert sorted(ranks[0]["metrics"]) == [0, 1, 2] and ranks[0]["step"] == 3
    assert any(k.startswith("d_opt.") and k.endswith(".exp_avg") for k in ranks[0]["state"])
    one = runs[1][0]["trainer"]
    for k, v in one["metrics"][0].items():
        np.testing.assert_allclose(ranks[0]["metrics"][0][k], v, rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)
    # step 0's D gradients, read from Adam's first moments (m = (1 - b1) g
    # from zero). The G phase runs on the D that Adam updated, and Adam's
    # first step maps a gradient within rounding of 0 to +-lr, so neither the
    # parameters nor the G phase's gradients are held here: the plain-step
    # test above holds those
    got, want = ranks[0]["snapshot"], one["snapshot"]
    keys = [k for k in want if k.startswith("d_opt.") and k.endswith(".exp_avg")]
    scale = max(float(want[k].abs().max()) for k in keys)
    worst = max(float((got[k] - want[k]).abs().max()) for k in keys)
    assert keys and worst <= GRAD_REL * scale, (worst, scale)
    assert ranks[0]["grad_all_reduce"]["bytes"] > 0


# ----------------------------------------------------------------- refusals


def test_launch_counts_and_refusals(monkeypatch):
    assert resolve_num_devices(None, 4, "cpu") == 1
    assert resolve_num_devices(2, 4, "cpu") == 2
    with pytest.raises(ValueError, match="does not divide"):
        resolve_num_devices(3, 4, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for present, batch, want in ((8, 4, 4), (3, 4, 2), (8, 6, 6), (1, 32, 1)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=present: n)
        assert resolve_num_devices(None, batch) == want
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="GPU"):
        resolve_num_devices(2, 4)
    with pytest.raises(ValueError, match="GPU"):
        launch(harness.run, 2, "cuda", args=([],))
    with pytest.raises(RuntimeError, match="launch"):
        make_mesh(2, "cpu")


def test_an_indexed_card_takes_one_rank(monkeypatch, tmp_path):
    """``--device cuda:1`` on a host of 4 cards trains and sweeps in one
    process on that card; a rank count above 1 with it is refused."""
    from stylex_tpu_torch import cli, run_attfind

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert resolve_num_devices(None, 32, "cuda") == 4
    assert resolve_num_devices(None, 32, "cuda:1") == 1
    assert resolve_num_devices(1, 32, "cuda:1") == 1
    with pytest.raises(ValueError, match="names one card"):
        resolve_num_devices(2, 32, "cuda:1")
    with pytest.raises(ValueError, match="names one card"):
        launch(harness.run, 2, "cuda:1", args=([],))

    meshes, launched = [], []
    monkeypatch.setattr(cli, "_train", lambda mesh, *a: meshes.append(mesh))
    monkeypatch.setattr(run_attfind, "extract", lambda mesh, args: meshes.append(mesh))
    monkeypatch.setattr("stylex_tpu_torch.parallel.launch",
                        lambda fn, n, device, args=(): launched.append((n, device)))
    dirs = ["--results-dir", str(tmp_path / "r"), "--models-dir", str(tmp_path / "m")]
    cli.main(["--dataset-name", "synthetic", "--device", "cuda:1"] + dirs)
    sweep = ["--checkpoint", "model.pt", "--config", "config.json", "--device"]
    run_attfind.main(sweep + ["cuda:1"])
    assert [(m.device, m.world_size, m.group) for m in meshes] == [
        (torch.device("cuda", 1), 1, None)] * 2
    cli.main(["--dataset-name", "synthetic", "--device", "cuda"] + dirs)
    run_attfind.main(sweep + ["cuda"])
    assert launched == [(4, "cuda")] * 2


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="KeyError"):
        launch(harness.run, 2, "cpu", args=([("no such case", {})],))
