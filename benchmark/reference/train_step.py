"""The plain reference of one StylEx train step, float32.

The step of the reference implementation as its CLI runs it (alternating
prior and encoder micro-batches, all micro-batches of a step in one pass):

1. D phase: w for every micro-batch (encoder micro-batches through E and
   the frozen classifier, prior ones through S with style mixing), fakes
   without gradient, D over [aug(fake); aug(real)], the hinge loss, on GP
   steps the gradient penalty 10 (||d sum D(aug(x)) / dx|| - 1)^2 on the
   reals; Adam on D.
2. G phase with the updated D: fakes with gradient, the mean D score, on
   PL steps the path-length penalty against ``pl_mean``, and on encoder
   micro-batches the reconstruction (0.1 LPIPS + 0.1 L1 on E + L1 on the
   image) and the classifier KL, both doubled under the alternation and
   halved for the encoder share; Adam on encoder, S and G.
3. ``pl_mean`` (EMA 0.99 of the last micro-batch's mean path length), the
   EMA copies (every ``ema_every`` steps after ``ema_start_step``), step + 1.

Adam is written out (betas 0.5, 0.9, eps 1e-8, D at ``lr * ttur_mult``;
the NEW arch trains the encoder at its own rate). Random draws arrive from
the caller as plain tensors, the same the program under test received.

This file imports nothing but torch and its siblings.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import nets

BETAS, EPS = (0.5, 0.9), 1e-8
GSUB = ("encoder", "S", "G")


class Adam:
    """torch.optim.Adam's arithmetic, without weight decay."""

    def __init__(self, groups: List[tuple]):
        self.groups = [(list(params), lr) for params, lr in groups]
        self.m = {id(p): torch.zeros_like(p) for ps, _ in self.groups for p in ps}
        self.v = {id(p): torch.zeros_like(p) for ps, _ in self.groups for p in ps}
        self.t = 0

    def load(self, moments: Dict[int, tuple], t: int) -> None:
        """Start from a run's state: ``moments[id(p)] = (m, v)`` for the
        parameters that have them (the others keep zeros) after ``t`` steps."""
        for i, (m, v) in moments.items():
            if i in self.m:
                self.m[i].copy_(m)
                self.v[i].copy_(v)
        self.t = t

    @torch.no_grad()
    def step(self, grads: Dict[int, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for params, lr in self.groups:
            for p in params:
                g = grads[id(p)]
                m, v = self.m[id(p)], self.v[id(p)]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.addcdiv_(m, (v.sqrt() / math.sqrt(bc2)).add_(EPS), value=-lr / bc1)


def g_params(model) -> list:
    return [p for name in GSUB for p in getattr(model, name).parameters()]


def make_optimizers(model, t: dict):
    lr = t["lr"]
    if model.cfg["arch"] == "new":
        enc_lr = t["encoder_lr"] if t.get("encoder_lr") is not None else 1e-5
        g = Adam([(model.encoder.parameters(), enc_lr),
                  (list(model.S.parameters()) + list(model.G.parameters()), lr)])
    else:
        g = Adam([(g_params(model), lr)])
    return g, Adam([(model.D.parameters(), lr * t["ttur_mult"])])


def flags(t: dict, step: int) -> Dict[str, bool]:
    return dict(gp=step % t["gp_every"] == 0,
                pl=step > t["pl_start_step"] and step % t["pl_every"] == 0,
                ema=step % t["ema_every"] == 0 and step > t["ema_start_step"],
                ema_reset=step <= t["ema_reset_until"] and step % t["ema_reset_every"] == 2)


# ------------------------------------------------------------ augmentation


def augment(x, draws):
    """The pre-D DiffAugment of translation (1/8) then cutout (1/2), on
    the samples whose gate is set, after their flip; ``draws`` is
    ``(gate, flip, ((th, tw), (oy, ox)))`` or None."""
    if draws is None:
        return x
    gate, flip, ((th, tw), (oy, ox)) = draws
    y = torch.where(flip.view(-1, 1, 1, 1), x.flip(3), x)
    n, _, h, w = y.shape
    yp = F.pad(y, (1, 1, 1, 1))
    rows = (torch.arange(h, device=x.device)[None, :, None] + th.view(-1, 1, 1) + 1).clamp(0, h + 1)
    cols = (torch.arange(w, device=x.device)[None, None, :] + tw.view(-1, 1, 1) + 1).clamp(0, w + 1)
    y = yp[torch.arange(n, device=x.device)[:, None, None], :, rows, cols].permute(0, 3, 1, 2)
    ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
    oy, ox = oy.view(-1, 1, 1), ox.view(-1, 1, 1)
    y0, y1 = (oy - ch // 2).clamp(0, h - 1), (oy - ch // 2 + ch - 1).clamp(0, h - 1)
    x0, x1 = (ox - cw // 2).clamp(0, w - 1), (ox - cw // 2 + cw - 1).clamp(0, w - 1)
    r = torch.arange(h, device=x.device)[None, :, None]
    c = torch.arange(w, device=x.device)[None, None, :]
    cut = (r >= y0) & (r <= y1) & (c >= x0) & (c <= x1)
    y = y * (1.0 - cut.to(y.dtype))[:, None]
    return torch.where(gate.view(-1, 1, 1, 1), y, x)


# ------------------------------------------------------------------ losses


def lpips_normalize(x):
    flat = x.reshape(x.shape[0], -1)
    mx, mn = flat.amax(1)[:, None, None, None], flat.amin(1)[:, None, None, None]
    return (x - mn) / (mx - mn) * 2.0 - 1.0


def reconstruction_loss(lpips, x, fake, fake_w, x_w):
    percep = nets.lpips_distance(lpips, lpips_normalize(x), lpips_normalize(fake)).mean()
    return 0.1 * percep + 0.1 * (x_w - fake_w).abs().mean() + (x - fake).abs().mean()


def kl_loss(real_logits, fake_logits):
    lr, lf = F.log_softmax(real_logits, -1), F.log_softmax(fake_logits, -1)
    return (lr.exp() * (lr - lf)).sum() / real_logits.shape[0]


def gradient_penalty(score_fn, images):
    images = images.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(score_fn(images).sum(), images, create_graph=True)
    return 10.0 * (g.reshape(g.shape[0], -1).norm(dim=1) - 1.0).square().mean()


def path_lengths(gen_fn, w, pl_noise):
    img = gen_fn(w)
    proj = (img * (pl_noise / (img.shape[2] * img.shape[3]) ** 0.5)).sum()
    (g,) = torch.autograd.grad(proj, w, create_graph=True)
    return g.square().sum(dim=2).mean(dim=1).sqrt()


# -------------------------------------------------------------------- step


def _flat(x):
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def images(x: torch.Tensor, device) -> torch.Tensor:
    """(A, B, S, S, 3) uint8 -> (A, B, 3, S, S) float32 in [0, 1]."""
    return (torch.as_tensor(x).to(device).float() / 255.0).permute(0, 1, 4, 2, 3).contiguous()


class Step:
    """``Step(model, classifier, lpips, t)(batch, draws, step, pl_mean)``
    runs one step on ``model`` in place and returns its losses (0-d
    tensors), the gradients Adam got for every parameter (by ``id``) and
    the new ``pl_mean``."""

    def __init__(self, model, classifier, lpips: dict, t: dict):
        self.model, self.classifier, self.lpips, self.t = model, classifier, lpips, t
        self.c = model.cfg
        self.g_opt, self.d_opt = make_optimizers(model, t)
        A = t["gradient_accumulate_every"]
        self.sched = [i % 2 == 1 for i in range(A)]  # alternating: odd ones are encoder input

    def classify(self, x):
        with torch.no_grad():
            return self.classifier(x)

    def assemble_w(self, dr, imgs, logits_all, probs_all):
        m, c, L = self.model, self.c, self.model.num_layers
        n, B = len(self.sched), imgs.shape[1]
        enc_idx = [i for i, f in enumerate(self.sched) if f]
        prior_idx = [i for i, f in enumerate(self.sched) if not f]
        parts = [None] * n
        enc_imgs = _flat(imgs[enc_idx])
        enc_logits = _flat(logits_all[enc_idx]) if logits_all is not None \
            else self.classify(enc_imgs)
        enc_out = m.encoder(enc_imgs)
        w = nets.make_w(c, enc_out, enc_logits).reshape(len(enc_idx), B, 1, -1)
        for j, i in enumerate(enc_idx):
            parts[i] = w[j].expand(B, L, w.shape[-1])
        P = len(prior_idx)
        w1 = m.S(_flat(dr["z1"])).reshape(P, B, 1, -1)
        w2 = m.S(_flat(dr["z2"])).reshape(P, B, 1, -1)
        cut = torch.where(dr["mixed"], dr["cutoff"], torch.full_like(dr["cutoff"], L))
        first = (torch.arange(L, device=cut.device)[None, :] < cut[:, None]).to(w1.dtype)
        wp = w1 * first[:, None, :, None] + w2 * (1.0 - first[:, None, :, None])
        if c["arch"] == "new":
            pb = probs_all[prior_idx][:, :, None, :].expand(P, B, L, c["num_classes"])
            wp = torch.cat([wp, pb], dim=-1)
        for j, i in enumerate(prior_idx):
            parts[i] = wp[j]
        return torch.stack(parts), enc_out, enc_imgs, enc_logits

    def conditioning(self, imgs):
        if self.c["arch"] != "new":
            return None, None
        logits = self.classify(_flat(imgs)).reshape(imgs.shape[0], imgs.shape[1], -1)
        return logits, torch.softmax(logits, -1)

    def __call__(self, batch, draws, step: int, pl_mean: torch.Tensor):
        m, t = self.model, self.t
        dev = m.G.initial_block.device
        imgs = {k: images(batch[k], dev) for k in ("d_real", "d_enc", "g_imgs")}
        fl = flags(t, step)
        new = self.c["arch"] == "new"
        A, B = imgs["d_real"].shape[:2]
        grads: Dict[int, torch.Tensor] = {}

        # D phase
        dr = draws["d"]
        logits_all, probs_all = self.conditioning(imgs["d_enc"])
        probs = _flat(probs_all) if new else None
        with torch.no_grad():
            w_all = self.assemble_w(dr, imgs["d_enc"], logits_all, probs_all)[0]
            fake = m.G(_flat(w_all), _flat(dr["noise"]))[0]
        real = _flat(imgs["d_real"])
        both = torch.cat([augment(fake, dr["aug_fake"]), augment(real, dr["aug_real"])])
        scores = m.D(both, torch.cat([probs, probs]) if new else None)
        fake_s, real_s = scores[:A * B].reshape(A, B), scores[A * B:].reshape(A, B)
        d_loss = (F.relu(1.0 + real_s) + F.relu(1.0 - fake_s)).mean()
        gp = torch.zeros((), device=dev)
        if fl["gp"]:
            gp = gradient_penalty(lambda im: m.D(augment(im, dr["aug_real"]), probs), real)
        d_params = list(m.D.parameters())
        for p, g in zip(d_params, torch.autograd.grad(d_loss + gp, d_params)):
            grads[id(p)] = g
        self.d_opt.step(grads)

        # G phase
        dr = draws["g"]
        logits_all, probs_all = self.conditioning(imgs["g_imgs"])
        probs = _flat(probs_all) if new else None
        w_all, enc_out, enc_imgs, enc_logits = self.assemble_w(dr, imgs["g_imgs"], logits_all,
                                                               probs_all)
        w_flat, noise = _flat(w_all), _flat(dr["noise"])
        fake = m.G(w_flat, noise)[0]
        fake_s = m.D(augment(fake, dr["aug_fake"]), probs).reshape(A, B)
        g_loss = fake_s.mean()
        zero = torch.zeros((), device=dev)
        pl_pen, pl_len = zero, None
        if fl["pl"]:
            lengths = path_lengths(lambda w: m.G(w, noise)[0], w_flat,
                                   _flat(dr["pl_noise"])).reshape(A, B)
            pens = (lengths - pl_mean).square().mean(dim=1)
            pl_pen = torch.where(pl_mean >= 0, pens, torch.zeros_like(pens)).mean()
            pl_len = lengths[-1].mean().detach()
        enc_idx = [i for i, f in enumerate(self.sched) if f]
        fake_enc = _flat(fake.reshape(A, B, *fake.shape[1:])[enc_idx])
        scale = 2.0 * len(enc_idx) / A  # doubled under the alternation
        rec = t["rec_scaling"] * scale * reconstruction_loss(
            self.lpips, enc_imgs, fake_enc, m.encoder(fake_enc), enc_out)
        kl = t["kl_scaling"] * scale * kl_loss(enc_logits, self.classifier(fake_enc))
        gp_list = g_params(m)
        gg = torch.autograd.grad(g_loss + pl_pen + rec + kl, gp_list, allow_unused=True)
        for p, g in zip(gp_list, gg):
            grads[id(p)] = torch.zeros_like(p) if g is None else g
        self.g_opt.step(grads)

        if fl["pl"]:
            pl_mean = torch.where(pl_mean < 0, pl_len, pl_mean * 0.99 + 0.01 * pl_len)
        with torch.no_grad():
            for live, ema in ((m.S, m.SE), (m.G, m.GE)):
                if fl["ema_reset"]:
                    ema.load_state_dict(live.state_dict())
                elif fl["ema"]:
                    for e, p in zip(ema.parameters(), live.parameters()):
                        e.copy_(e * t["ema_beta"] + (1.0 - t["ema_beta"]) * p)
        losses = dict(d_loss=d_loss, gp=gp, g_loss=g_loss, rec_loss=rec, kl_loss=kl,
                      pl_mean=pl_mean)
        return losses, grads, pl_mean
