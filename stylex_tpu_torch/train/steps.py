"""The StylEx train step: the JAX package's train steps in eager PyTorch.

With ``fused_microbatches`` (the default) one call runs a whole optimizer
step over ``gradient_accumulate_every`` (A) micro-batches of B images,
batched as A*B samples. Without it (the scan step) the same phases run one
micro-batch at a time, as the reference's loop does, and the step sums each
micro-batch's gradients and losses / A: the same step up to the order of
float sums, with per-micro-batch draws and penalties.

1. D phase: w for every micro-batch (encoder micro-batches through E and
   the classifier, prior ones through S with style mixing), fakes without
   gradient, one D pass over [aug(fake); aug(real)], the hinge (or dual
   contrastive) loss with per-micro-batch relativistic means, on GP steps
   the R1-style gradient penalty on the reals, with ``fq_layers`` the
   quantize layers' commitment losses of the scoring pass, and with
   ``cl_reg`` the contrastive loss of two views of the reals (and, after
   step 20,000, of the fakes). D is updated; then, with ``fq_layers``, the
   codebooks of D and E take their EMA update from the last real and the
   last encoder micro-batch, before the G phase runs.
2. G phase: fakes with gradient, D scores with per-micro-batch top-k (or
   the dual contrastive loss against detached real scores), on PL steps the
   path-length penalty, and on encoder micro-batches the reconstruction
   (LPIPS + L1) and classifier KL losses. encoder, S and G are updated.
3. ``pl_mean`` (EMA 0.99 of the path length), the EMA copies ``SE``/``GE``
   (every ``ema_every`` after ``ema_start_step``; reset to the live nets at
   ``step % ema_reset_every == 2`` until ``ema_reset_until``), ``step + 1``.

The three are the spans ``train.d_phase`` (with D's Adam step and the
codebooks' update), ``train.g_phase`` and ``train.update`` (G's Adam step,
``pl_mean`` and the EMA copies) of :mod:`stylex_tpu_torch.utils.tracing`.

Micro-batches alternate prior (even) and encoder (odd) inputs, as the
reference's loop does; rec/KL are doubled under the alternation (and always
in the OLD arch). A*B samples are flattened micro-batch-major.

With a ``mesh`` of several ranks (:mod:`stylex_tpu_torch.parallel`) each rank
takes its contiguous slice of every micro-batch's B images and of the
step's global draws, and the step computes what one process computes on the
whole batch: the per-sample values that a loss couples or averages (D
scores, path lengths, the contrastive features) are gathered, the
per-sample means (GP, rec, KL, the commitment loss) are averaged over the
ranks' equal shares, every rank computes the same global losses, and each
phase's gradients are summed over the ranks in one bucket before its
optimizer step. The quantize layers' EMA update sums the ranks' statistics.

Gradients come from ``torch.autograd.grad`` over explicit parameter lists;
the frozen classifier and the EMA copies take none. Both penalties are
second-order, so their gradients differentiate through the kernels'
backward (``ops/blur.py``). Randomness arrives as a :class:`StepDraws`,
from :func:`draw_step` or from the caller (the tests pass in the JAX
package's draws); both steps read the same draws.

``compute_dtype='bfloat16'``: each net runs on bfloat16 copies of its
float32 parameters, cast on the autograd graph inside the loss
(``torch.func.functional_call``), with bfloat16 inputs; the float32 master
weights receive the gradients. The classifier and LPIPS stay float32.
``compute_dtype='float64'`` runs the same way on float64 copies, with
losses and scores in float64: the witness that float32 rounding is measured
against, on the CPU (the CUDA kernels take float32 and bfloat16), with a
classifier in float64.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.func import functional_call

from stylex_tpu_torch.config import Arch, ModelConfig, TrainConfig
from stylex_tpu_torch.device import map_tensors, resolve_dtype
from stylex_tpu_torch.losses import (
    classifier_kl_loss,
    d_hinge_loss,
    dual_contrastive_loss,
    gradient_penalty,
    path_lengths,
    reconstruction_loss,
)
from stylex_tpu_torch.losses.contrastive import contrastive_d_loss, draw_views
from stylex_tpu_torch.models.stylex import ema_update, make_w
from stylex_tpu_torch.ops.diffaug import AugmentDraws, augment_for_discriminator, draw_augment
from stylex_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    all_reduce_grads,
    data_sharding,
    gather,
)
from stylex_tpu_torch.train.state import TrainState, g_parameters
from stylex_tpu_torch.utils import tracing

__all__ = [
    "PhaseDraws",
    "StepDraws",
    "draw_step",
    "make_train_step",
    "microbatch_schedule",
    "shard_draws",
    "step_flags",
]

# fakes join the contrastive regulariser after this step
CL_GEN_START = 20_000

Views = Tuple[AugmentDraws, AugmentDraws]


class PhaseDraws(NamedTuple):
    """The random draws of one phase. P is the number of prior
    micro-batches, A the number of micro-batches, B the micro-batch size.

    z1, z2: (P, B, mapping_dim) latents of the two mixed styles.
    mixed: (P,) bool, whether the micro-batch mixes styles.
    cutoff: (P,) int64 in [0, num_layers): the first layer that takes z2.
    noise: (A, B, S, S, 1) uniform noise images.
    aug_fake, aug_real: DiffAugment draws over the A*B fakes and reals, or
      None without augmentation.
    pl_noise: (A, B, C, S, S) unit normal projection noise of the
      path-length penalty (G phase of a PL step), else None.
    cl_real, cl_fake: the two contrastive views' draws over the A*B reals
      (D phase with ``cl_reg``) and fakes (after step 20,000), else None.
    """

    z1: torch.Tensor
    z2: torch.Tensor
    mixed: torch.Tensor
    cutoff: torch.Tensor
    noise: torch.Tensor
    aug_fake: Optional[AugmentDraws]
    aug_real: Optional[AugmentDraws]
    pl_noise: Optional[torch.Tensor] = None
    cl_real: Optional[Views] = None
    cl_fake: Optional[Views] = None


class StepDraws(NamedTuple):
    d: PhaseDraws
    g: PhaseDraws


def microbatch_schedule(accum: int, alternating: bool) -> List[bool]:
    """Whether each micro-batch takes encoder input: odd ones under
    alternating training, all of them otherwise."""
    return [(not alternating) or i % 2 == 1 for i in range(accum)]


def step_flags(tc: TrainConfig, step: int) -> Dict[str, bool]:
    """Which periodic parts run at ``step``."""
    return dict(
        gp=step % tc.gp_every == 0,
        pl=(not tc.no_pl_reg) and step > tc.pl_start_step and step % tc.pl_every == 0,
        ema=step % tc.ema_every == 0 and step > tc.ema_start_step,
        ema_reset=step <= tc.ema_reset_until and step % tc.ema_reset_every == 2,
        cl_gen=tc.cl_reg and step > CL_GEN_START,
    )


def draw_step(generator: torch.Generator, model_cfg: ModelConfig, train_cfg: TrainConfig,
              batch_size: int, num_layers: int, aug_prob: float, step: int) -> StepDraws:
    """Every random draw of step ``step``, on ``generator``'s device."""
    tc, dev = train_cfg, generator.device
    A, B, S = tc.gradient_accumulate_every, batch_size, model_cfg.image_size
    P = A - sum(microbatch_schedule(A, tc.alternating_training))
    channels = 4 if model_cfg.transparent else 3
    flags = step_flags(tc, step)

    def phase(d_phase: bool) -> PhaseDraws:
        def randn(*shape):
            return torch.randn(*shape, generator=generator, device=dev)

        return PhaseDraws(
            z1=randn(P, B, model_cfg.mapping_dim),
            z2=randn(P, B, model_cfg.mapping_dim),
            mixed=torch.rand(P, generator=generator, device=dev) < tc.mixed_prob,
            cutoff=torch.randint(0, num_layers, (P,), generator=generator, device=dev),
            noise=torch.rand(A, B, S, S, 1, generator=generator, device=dev),
            aug_fake=draw_augment(generator, A, B, S, aug_prob, tc.aug_types),
            aug_real=draw_augment(generator, A, B, S, aug_prob, tc.aug_types),
            pl_noise=randn(A, B, channels, S, S) if flags["pl"] and not d_phase else None,
            cl_real=draw_views(generator, A, B, S) if tc.cl_reg and d_phase else None,
            cl_fake=draw_views(generator, A, B, S) if flags["cl_gen"] and d_phase else None,
        )

    return StepDraws(phase(True), phase(False))


def _take(x, lo: int, hi: int):
    """Rows lo:hi of every tensor in a (nested) tuple of draws; None stays."""
    return map_tensors(x, lambda t: t[lo:hi])


def shard_draws(draws: StepDraws, mesh: Mesh, accum: int) -> StepDraws:
    """This rank's slice of a step's global draws: the (., B, ...) latents
    and noise along B, the flat (A*B,) DiffAugment and view draws within
    each of the ``accum`` micro-batches; the per-micro-batch mixing draws
    whole."""
    def along_b(x):
        return x[:, data_sharding(mesh, x.shape[1])]

    def flat(x):
        x = x.reshape(accum, x.shape[0] // accum, *x.shape[1:])
        return along_b(x).reshape(-1, *x.shape[2:])

    def phase(dr: PhaseDraws) -> PhaseDraws:
        return dr._replace(z1=along_b(dr.z1), z2=along_b(dr.z2), noise=along_b(dr.noise),
                           pl_noise=map_tensors(dr.pl_noise, along_b),
                           **{k: map_tensors(getattr(dr, k), flat)
                              for k in ("aug_fake", "aug_real", "cl_real", "cl_fake")})

    return StepDraws(phase(draws.d), phase(draws.g))


def _micro_draws(dr: PhaseDraws, i: int, B: int, prior_pos: Optional[int]) -> PhaseDraws:
    """Micro-batch ``i``'s draws; ``prior_pos`` is its place among the prior
    micro-batches (None for an encoder micro-batch)."""
    p = (0, 0) if prior_pos is None else (prior_pos, prior_pos + 1)
    return PhaseDraws(
        *(_take(t, *p) for t in (dr.z1, dr.z2, dr.mixed, dr.cutoff)),
        noise=dr.noise[i:i + 1],
        **{k: _take(getattr(dr, k), i * B, (i + 1) * B)
           for k in ("aug_fake", "aug_real", "cl_real", "cl_fake")},
        pl_noise=_take(dr.pl_noise, i, i + 1),
    )


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(A, B, ...) -> (A*B, ...), micro-batch-major."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _images(x, device, dtype) -> torch.Tensor:
    """(A, B, S, S, C) NHWC images, uint8 or float in [0, 1], -> ``dtype``
    (A, B, C, S, S) on ``device``; uint8 is divided by 255 there."""
    x = torch.as_tensor(x).to(device, non_blocking=True)
    x = x.to(dtype) / 255.0 if x.dtype == torch.uint8 else x.to(dtype)
    return x.permute(0, 1, 4, 2, 3).contiguous()


def _cast(module: torch.nn.Module, dtype: torch.dtype) -> Callable:
    """``module`` as a function that runs on ``dtype`` copies of its
    parameters, cast on the autograd graph, with its floating inputs cast
    to ``dtype``."""
    if dtype == torch.float32:
        return module
    params = {n: p.to(dtype) for n, p in module.named_parameters()}

    def call(*args, **kwargs):
        args = tuple(a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a
                     for a in args)
        return functional_call(module, params, args, kwargs)

    return call


def _apply_grads(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads, strict=True):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def _add(acc, grads, scale: float):
    """``acc + scale * grads`` elementwise over lists (None counts as 0)."""
    if scale != 1.0:
        grads = [None if g is None else g * scale for g in grads]
    if acc is None:
        return list(grads)
    return [a if g is None else g if a is None else a + g for a, g in zip(acc, grads)]


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    classifier_fn: Callable[[torch.Tensor], torch.Tensor], lpips_params,
                    aug_prob: Optional[float] = None, mesh: Optional[Mesh] = None):
    """Build ``step(state, batch, draws) -> metrics``.

    ``batch`` holds (A, B, S, S, C) NHWC image stacks, uint8 or float in
    [0, 1], numpy or torch: ``d_real`` and ``d_enc`` (D phase), ``g_imgs``
    (G phase), ``g_real`` with ``dual_contrast_loss``, and an optional int
    ``top_k``. The step updates ``state`` in place and returns 0-d float32
    tensors on the device: ``d_loss``, ``g_loss``, ``rec_loss``,
    ``kl_loss``, ``gp``, ``pl_mean``, and ``q_loss`` with ``fq_layers``,
    ``cr_loss`` with ``cl_reg``. ``aug_prob`` overrides the config's (None
    there means 0).

    With a ``mesh`` of several ranks, ``batch`` is this rank's slice of the
    global batch along B (:func:`~stylex_tpu_torch.parallel.shard_batch`)
    and ``draws`` the step's global draws, the same on every rank; the
    metrics are the global step's, equal on every rank.
    """
    cfg, tc = model_cfg, train_cfg
    A = tc.gradient_accumulate_every
    schedule = microbatch_schedule(A, tc.alternating_training)
    dtype = torch.float64 if tc.compute_dtype == "float64" else resolve_dtype(tc.compute_dtype)
    wide = torch.promote_types(dtype, torch.float32)  # images, scores and losses
    L = int(math.log2(cfg.image_size)) - 1  # generator layers
    new = cfg.arch == Arch.NEW
    double = 2.0 if (cfg.arch == Arch.OLD or tc.alternating_training) else 1.0
    eff_rec, eff_kl = double * tc.rec_scaling, double * tc.kl_scaling
    aug_types = tuple(tc.aug_types)
    if aug_prob is None:
        aug_prob = tc.aug_prob if tc.aug_prob is not None else 0.0
    ranks = 1 if mesh is None else mesh.world_size
    if mesh is not None and mesh.group is None:
        mesh = None  # the single process

    def across(x):
        """(n, b, ...) per-sample values of this rank -> (n, B, ...)."""
        return gather(x, mesh, dim=1)

    def mean_across(x):
        """A mean over this rank's share of the batch -> over the batch."""
        return x if mesh is None else gather(x.reshape(1), mesh).mean()

    def classify(x):
        return classifier_fn(x.to(wide)).to(wide)

    def augment(x, draws):
        return augment_for_discriminator(x.to(dtype), draws if aug_prob > 0 else None, aug_types)

    def assemble_w(nets, dr: PhaseDraws, imgs, logits_all, probs_all, sched):
        """(n, B, L, D) w of the n micro-batches of ``sched`` in order, with
        the encoder micro-batches' encodings, images and logits
        (flattened), or Nones."""
        n, B = len(sched), imgs.shape[1]
        enc_idx = [i for i, f in enumerate(sched) if f]
        prior_idx = [i for i, f in enumerate(sched) if not f]
        parts: List[Optional[torch.Tensor]] = [None] * n
        enc_out = enc_imgs = enc_logits = None
        if enc_idx:
            enc_imgs = _flat(imgs[enc_idx])
            if logits_all is not None:
                enc_logits = _flat(logits_all[enc_idx])
            else:
                with torch.no_grad():
                    enc_logits = classify(enc_imgs)
            enc_out = nets["encoder"](enc_imgs)
            w = make_w(cfg, enc_out, enc_logits).to(dtype).reshape(len(enc_idx), B, 1, -1)
            for j, i in enumerate(enc_idx):
                parts[i] = w[j].expand(B, L, w.shape[-1])
        if prior_idx:
            P = len(prior_idx)
            w1 = nets["S"](_flat(dr.z1)).reshape(P, B, 1, -1)
            w2 = nets["S"](_flat(dr.z2)).reshape(P, B, 1, -1)
            cut = torch.where(dr.mixed, dr.cutoff, torch.full_like(dr.cutoff, L))
            first = (torch.arange(L, device=cut.device)[None, :] < cut[:, None]).to(w1.dtype)
            first = first[:, None, :, None]  # (P, 1, L, 1)
            w = w1 * first + w2 * (1.0 - first)
            if new:
                pb = probs_all[prior_idx][:, :, None, :].expand(P, B, L, cfg.num_classes)
                w = torch.cat([w, pb.to(w.dtype)], dim=-1)
            for j, i in enumerate(prior_idx):
                parts[i] = w[j].to(dtype)
        return torch.stack(parts), enc_out, enc_imgs, enc_logits

    def nets_of(model, names):
        return {name: _cast(getattr(model, name), dtype) for name in names}

    def conditioning(imgs):
        """NEW arch: (n, B, K) logits and probabilities of the real images."""
        if not new:
            return None, None
        with torch.no_grad():
            logits = classify(_flat(imgs)).reshape(imgs.shape[0], imgs.shape[1], -1)
        return logits, torch.softmax(logits, dim=-1)

    # The phases take any run of micro-batches (all of them in the fused
    # step, one at a time in the scan step) and return their losses as
    # means over those micro-batches, and the gradients of those means.

    # ------------------------------------------------------------- D phase
    def d_phase(state: TrainState, imgs, dr: PhaseDraws, sched, flags):
        model = state.model
        d_real, d_enc = imgs["d_real"], imgs["d_enc"]
        n, B = len(sched), d_real.shape[1]
        enc_idx = [i for i, f in enumerate(sched) if f]
        logits_all, probs_all = conditioning(d_enc)
        probs_flat = _flat(probs_all) if new else None
        with torch.no_grad():
            nets = nets_of(model, ("encoder", "S", "G"))
            w_all, _, enc_imgs, enc_logits = assemble_w(nets, dr, d_enc, logits_all, probs_all,
                                                        sched)
            fake = nets["G"](_flat(w_all), _flat(dr.noise))[0]

        D = _cast(model.D, dtype)
        real_flat = _flat(d_real)
        probs2 = torch.cat([probs_flat, probs_flat]) if new else None
        both = torch.cat([augment(fake, dr.aug_fake), augment(real_flat, dr.aug_real)])
        scores, q_loss = D(both, probs2, return_q_loss=True)
        scores, q_loss = scores.to(wide), q_loss.to(wide)
        # each commitment loss is a mean over the 2nB batch: x2 gives the
        # fake pass's plus the real pass's
        q_loss = mean_across(2.0 * q_loss)
        fake_s = across(scores[:n * B].reshape(n, B))
        real_s = across(scores[n * B:].reshape(n, B))
        r, f = real_s, fake_s
        if tc.rel_disc_loss:  # per-micro-batch means
            r = real_s - fake_s.mean(dim=1, keepdim=True)
            f = fake_s - real_s.mean(dim=1, keepdim=True)
        if tc.dual_contrast_loss:
            div = torch.stack([dual_contrastive_loss(r[i], f[i]) for i in range(n)]).mean()
        else:
            div = d_hinge_loss(r, f)
        zero = torch.zeros((), dtype=wide, device=div.device)
        gp = zero
        if flags["gp"]:
            gp = mean_across(gradient_penalty(lambda im: D(augment(im, dr.aug_real), probs_flat),
                                              real_flat))
        cr = zero
        if tc.cl_reg:
            def features(im):
                return D(im, return_features=True)

            gather_fn = None if mesh is None else across
            cr = contrastive_d_loss(features, real_flat.to(dtype), dr.cl_real, n,
                                    gather=gather_fn).to(wide)
            if flags["cl_gen"]:
                cr = cr + contrastive_d_loss(features, fake, dr.cl_fake, n,
                                             gather=gather_fn).to(wide)
        d_grads = torch.autograd.grad(div + gp + q_loss + cr, list(model.D.parameters()))

        gside = None
        if tc.kl_rec_during_disc and new and enc_idx:
            # rec/KL of the encoder micro-batches in float32, folded into
            # the G update
            enc_out = model.encoder(enc_imgs)
            w = make_w(cfg, enc_out, enc_logits)[:, None].expand(-1, L, -1)
            fake2 = model.G(w, _flat(dr.noise[enc_idx]))[0]
            rec = tc.rec_scaling * reconstruction_loss(
                lpips_params, enc_imgs, fake2, model.encoder(fake2), enc_out)
            kl = tc.kl_scaling * classifier_kl_loss(enc_logits, classify(fake2))
            gside = torch.autograd.grad(mean_across(rec + kl) * (len(enc_idx) / n),
                                        g_parameters(model), allow_unused=True)
        losses = dict(d_loss=div, gp=gp, q_loss=q_loss, cr_loss=cr)
        return d_grads, gside, {k: v.detach() for k, v in losses.items()}

    # ------------------------------------------------------------- G phase
    def g_phase(state: TrainState, imgs, dr: PhaseDraws, sched, flags, top_k: int):
        model = state.model
        g_imgs = imgs["g_imgs"]
        n, B = len(sched), g_imgs.shape[1]
        enc_idx = [i for i, f in enumerate(sched) if f]
        zero = torch.zeros((), device=g_imgs.device)
        logits_all, probs_all = conditioning(g_imgs)
        probs_flat = _flat(probs_all) if new else None
        nets = nets_of(model, ("encoder", "S", "G", "D"))
        w_all, enc_out, enc_imgs, enc_logits = assemble_w(nets, dr, g_imgs, logits_all, probs_all,
                                                          sched)
        w_flat, noise_flat = _flat(w_all), _flat(dr.noise)
        fake = nets["G"](w_flat, noise_flat)[0]
        fake_s = across(nets["D"](augment(fake, dr.aug_fake), probs_flat).to(wide).reshape(n, B))

        if tc.dual_contrast_loss:
            with torch.no_grad():
                real_s = across(nets["D"](augment(_flat(imgs["g_real"]), dr.aug_real),
                                          probs_flat).to(wide).reshape(n, B))
            gen = torch.stack([dual_contrastive_loss(fake_s[i], real_s[i])
                               for i in range(n)]).mean()
        else:
            # per-micro-batch top-k: the k smallest scores
            ranked = fake_s.sort(dim=1).values
            keep = (torch.arange(ranked.shape[1], device=ranked.device) < top_k).to(ranked.dtype)
            gen = ((ranked * keep).sum(dim=1) / max(top_k, 1)).mean()

        pl_pen = pl_len = zero
        if flags["pl"]:
            if dr.pl_noise is None:
                raise ValueError("a path-length step needs draws.g.pl_noise")
            lengths = across(path_lengths(lambda w: nets["G"](w, noise_flat)[0], w_flat,
                                          _flat(dr.pl_noise)).to(wide).reshape(n, B))
            pens = (lengths - state.pl_mean).square().mean(dim=1)
            pl_pen = torch.where(state.pl_mean >= 0, pens, torch.zeros_like(pens)).mean()
            pl_len = lengths[-1].mean().detach()  # the last micro-batch's mean length

        rec = kl = zero
        if enc_idx:
            fake_enc = _flat(fake.reshape(n, B, *fake.shape[1:])[enc_idx])
            scale = len(enc_idx) / n
            rec = eff_rec * scale * mean_across(reconstruction_loss(
                lpips_params, enc_imgs, fake_enc, nets["encoder"](fake_enc), enc_out))
            kl = eff_kl * scale * mean_across(classifier_kl_loss(enc_logits, classify(fake_enc)))

        grads = torch.autograd.grad(gen + pl_pen + rec + kl, g_parameters(model),
                                    allow_unused=True)
        losses = dict(g_loss=gen, rec_loss=rec, kl_loss=kl)
        return grads, {k: v.detach() for k, v in losses.items()}, pl_len

    # ---------------------------------------------- fused and scan phases
    def scan_micro(imgs, dr: PhaseDraws, i: int):
        """Micro-batch ``i``'s images, draws and schedule."""
        B = imgs["d_real"].shape[1]
        prior_pos = sum(1 for f in schedule[:i] if not f)
        return ({k: v[i:i + 1] for k, v in imgs.items()},
                _micro_draws(dr, i, B, None if schedule[i] else prior_pos), [schedule[i]])

    def run_d(state, imgs, dr: PhaseDraws, flags):
        """(D gradients summed over the ranks, this rank's encoder/S/G
        gradients from the D phase or None, losses)."""
        if tc.fused_microbatches:
            d_grads, gside, losses = d_phase(state, imgs, dr, schedule, flags)
            return all_reduce_grads(d_grads, mesh), gside, losses
        d_grads = gside = None
        losses: Dict[str, torch.Tensor] = {}
        for i in range(A):
            grads, side, part = d_phase(state, *scan_micro(imgs, dr, i), flags)
            d_grads = _add(d_grads, grads, 1.0 / A)
            if side is not None:
                gside = _add(gside, side, 1.0 / A)
            losses = {k: losses.get(k, 0.0) + v / A for k, v in part.items()}
        return all_reduce_grads(d_grads, mesh), gside, losses

    def run_g(state, imgs, dr: PhaseDraws, flags, top_k: int, gside):
        """(encoder/S/G gradients, gside added, summed over the ranks;
        losses; the last micro-batch's mean path length)."""
        if tc.fused_microbatches:
            grads, losses, pl_len = g_phase(state, imgs, dr, schedule, flags, top_k)
            return all_reduce_grads(_add(gside, grads, 1.0), mesh), losses, pl_len
        g_grads, losses, pl_len = gside, {}, None
        for i in range(A):
            grads, part, pl_len = g_phase(state, *scan_micro(imgs, dr, i), flags, top_k)
            g_grads = _add(g_grads, grads, 1.0 / A)
            losses = {k: losses.get(k, 0.0) + v / A for k, v in part.items()}
        return all_reduce_grads(g_grads, mesh), losses, pl_len

    @torch.no_grad()
    def update_codebooks(model, imgs):
        """The quantize layers' EMA update, on the last real micro-batch
        through D (uniform class probabilities in the NEW arch) and the last
        encoder-input micro-batch through E."""
        last_real = imgs["d_real"][-1].to(torch.float32)
        uniform = None
        if new:
            uniform = last_real.new_full((last_real.shape[0], cfg.num_classes),
                                         1.0 / cfg.num_classes)
        ranks_sum = functools.partial(all_reduce_, mesh=mesh)  # the statistics' sum
        model.D(last_real, uniform, update_vq=True, vq_reduce=ranks_sum)
        if cfg.encoder_class is None:
            model.encoder(imgs["d_enc"][-1].to(torch.float32), update_vq=True,
                          vq_reduce=ranks_sum)

    # ------------------------------------------------------------ full step
    def step(state: TrainState, batch, draws: StepDraws) -> Dict[str, torch.Tensor]:
        model = state.model
        dev = state.device
        keys = ("d_real", "d_enc", "g_imgs") + (("g_real",) if tc.dual_contrast_loss else ())
        imgs = {k: _images(batch[k], dev, wide) for k in keys}
        flags = step_flags(tc, state.step)
        top_k = int(batch.get("top_k", imgs["g_imgs"].shape[1] * ranks))
        if mesh is not None:
            draws = shard_draws(draws, mesh, A)

        with tracing.span("train.d_phase"):
            d_grads, gside, d_losses = run_d(state, imgs, draws.d, flags)
            _apply_grads(state.d_opt, list(model.D.parameters()), d_grads)
            if cfg.fq_layers:
                update_codebooks(model, imgs)

        with tracing.span("train.g_phase"):
            g_grads, g_losses, pl_len = run_g(state, imgs, draws.g, flags, top_k, gside)

        with tracing.span("train.update"):
            params = g_parameters(model)
            g_grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, g_grads)]
            _apply_grads(state.g_opt, params, g_grads)
            if flags["pl"]:
                state.pl_mean = torch.where(state.pl_mean < 0, pl_len,
                                            state.pl_mean * 0.99 + 0.01 * pl_len)
            with torch.no_grad():
                for live, ema in ((model.S, model.SE), (model.G, model.GE)):
                    if flags["ema_reset"]:
                        ema.load_state_dict(live.state_dict())
                    elif flags["ema"]:
                        ema_update(ema, live, tc.ema_beta)
        state.step += 1
        metrics = {**{k: d_losses[k] for k in ("d_loss", "gp")}, **g_losses,
                   "pl_mean": state.pl_mean.detach().clone()}
        if cfg.fq_layers:
            metrics["q_loss"] = d_losses["q_loss"]
        if tc.cl_reg:
            metrics["cr_loss"] = d_losses["cr_loss"]
        return metrics

    return step
