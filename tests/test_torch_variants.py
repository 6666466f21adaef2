"""The port's model variants against the JAX package's, on the CPU: linear
attention (``attn_layers``) in G and D/E, the ``no_const`` stem, vector
quantization (``fq_layers``) with its EMA update, the contrastive loss of
``cl_reg``, the debug encoders, and block resume with attention and
``no_const``.

JAX parameters from a seed go through the weight bridge into the port; the
same numpy inputs (NHWC on the JAX side) go through both, float32; values
agree to 1e-5 x max|ref|. Forwards run the default (fused) graph unless a
test says otherwise.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu.config import Arch as JArch, ModelConfig as JModelConfig
from stylex_tpu.losses import contrastive as jcl
from stylex_tpu.models import build_stylex as j_build_stylex, init_stylex_params
from stylex_tpu.models import layers as jlayers
from stylex_tpu.ops import vq as jvq
from stylex_tpu.ops.fusion import prefer_literal_resample as j_literal
from stylex_tpu.ops.latents import expand_styles as j_expand
from stylex_tpu_torch.config import Arch, ModelConfig
from stylex_tpu_torch.losses import contrastive as tcl
from stylex_tpu_torch.models import layers as tlayers
from stylex_tpu_torch.models.convert import _attn, stylex_state_dict_from_jax
from stylex_tpu_torch.models.stylex import StylEx
from stylex_tpu_torch.ops import diffaug as taug
from stylex_tpu_torch.ops import vq as tvq
from stylex_tpu_torch.ops.fusion import prefer_literal_resample

from test_torch_diffaug import jax_pipeline_draws

torch.set_num_threads(2)

REL = 1e-5
TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)


@pytest.fixture(autouse=True)
def default_graph(monkeypatch):
    monkeypatch.delenv("STYLEX_TPU_NO_FUSED_UPCONV", raising=False)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _pair(arch="old", **model_kwargs):
    """(JAX modules, JAX params, the port's model with those weights), built
    once per configuration."""
    kw = {**TINY, **model_kwargs}
    jcfg = JModelConfig(arch=JArch(arch), **kw)
    modules = j_build_stylex(jcfg)
    params = init_stylex_params(jax.random.PRNGKey(0), modules)
    cfg = ModelConfig(arch=Arch(arch), **kw)
    model = StylEx(cfg)
    model.load_state_dict(stylex_state_dict_from_jax(_np(params), cfg))
    return modules, params, model.eval()


def _inputs(seed, latent=TINY["latent_dim"], size=16, coords=None, batch=3):
    rng = np.random.RandomState(seed)
    out = dict(w=rng.randn(batch, latent).astype(np.float32),
               noise=rng.rand(1, size, size, 1).astype(np.float32),
               x=rng.rand(batch, size, size, 3).astype(np.float32))
    if coords:
        out["delta"] = (rng.randn(batch, coords) * 0.5).astype(np.float32)
    return out


# ------------------------------------------------------------- attention


def test_attention_layers_match_jax():
    dim = 8
    x = np.random.RandomState(0).randn(2, 6, 5, dim).astype(np.float32)
    jmod = jlayers.AttnAndFF(dim)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    sd = {}
    _attn(sd, "m", _np(params))
    port = tlayers.AttnAndFF(dim)
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), jmod.apply({"params": params}, jnp.asarray(x)))
        attn_j = jlayers.LinearAttention(dim).apply({"params": params["attn"]}, jnp.asarray(x))
        _close(_nhwc(port[0].fn.fn(_nchw(x))), attn_j)
        norm_j = jlayers.ChanNorm().apply({"params": params["norm1"]}, jnp.asarray(x))
        _close(_nhwc(port[0].fn.norm(_nchw(x))), norm_j)


@pytest.mark.parametrize("literal", [False, True])
def test_generator_with_attention_and_no_const_matches_jax(literal):
    """``no_const`` decides the stem's tap orientation; the attention runs
    before blocks 1 and 2 (num_layers - ind in (1, 2))."""
    modules, params, model = _pair("old", attn_layers=(1, 2), no_const=True)
    assert model.G.attns[0] is None and model.G.attns[1] is not None
    inp = _inputs(1, coords=model.total_style_coords)
    L = modules.num_layers
    w_j = j_expand(jnp.asarray(inp["w"]), L)
    ctx_j = j_literal() if literal else contextlib.nullcontext()
    ctx_t = prefer_literal_resample() if literal else contextlib.nullcontext()
    with ctx_j:
        rgb_j, coords_j = modules.generate(params, w_j, jnp.asarray(inp["noise"]),
                                           style_delta=jnp.asarray(inp["delta"]))
    with ctx_t, torch.no_grad():
        rgb, coords = model.generate(torch.from_numpy(inp["w"])[:, None].expand(-1, L, -1),
                                     torch.from_numpy(inp["noise"]),
                                     style_delta=torch.from_numpy(inp["delta"]))
    _close(_nhwc(rgb), rgb_j)
    _close(coords, coords_j)


@pytest.mark.parametrize("start_block", [0, 1, 2])
def test_block_resume_with_attention_and_no_const_matches_jax(start_block):
    """Resuming at block k from the captured entry state (before block k's
    attention) gives the full forward's output, as in the JAX package."""
    modules, params, model = _pair("old", attn_layers=(1, 2), no_const=True)
    inp = _inputs(2, coords=model.total_style_coords)
    L = modules.num_layers
    w_j = j_expand(jnp.asarray(inp["w"]), L)
    w_t = torch.from_numpy(inp["w"])[:, None].expand(-1, L, -1)
    noise_t, delta_t = torch.from_numpy(inp["noise"]), torch.from_numpy(inp["delta"])
    with j_literal():
        _, _, states_j = modules.generate(params, w_j, jnp.asarray(inp["noise"]),
                                          style_delta=jnp.asarray(inp["delta"]),
                                          capture_states=True)
        xj, rj = states_j[start_block]
        rgb_j, _ = modules.generate(params, w_j, jnp.asarray(inp["noise"]),
                                    style_delta=jnp.asarray(inp["delta"]),
                                    start_block=start_block, initial_state=(xj, rj))
    with prefer_literal_resample(), torch.no_grad():
        _, _, states = model.generate(w_t, noise_t, style_delta=delta_t, capture_states=True)
        x, r = states[start_block]
        _close(_nhwc(x), xj)
        rgb, _ = model.generate(w_t, noise_t, style_delta=delta_t, start_block=start_block,
                                initial_state=(x, r))
        full, _ = model.generate(w_t, noise_t, style_delta=delta_t)
    _close(_nhwc(rgb), rgb_j)
    _close(rgb, full)


@pytest.mark.parametrize("arch", ["old", "new"])
def test_discriminator_with_attention_matches_jax(arch):
    modules, params, model = _pair(arch, attn_layers=(1, 2), no_const=True)
    assert model.D.attn_blocks[0] is not None and model.D.attn_blocks[2] is None
    x = _inputs(3)["x"]
    probs = np.random.RandomState(4).dirichlet([1.0, 1.0], size=3).astype(np.float32)
    with torch.no_grad():
        d = model.discriminate(_nchw(x), torch.from_numpy(probs) if arch == "new" else None)
        e = model.encode(_nchw(x))
    _close(d, modules.discriminate(params, jnp.asarray(x),
                                   jnp.asarray(probs) if arch == "new" else None))
    _close(e, modules.encode(params, jnp.asarray(x)))


# ------------------------------------------------------------ quantization


def test_vector_quantize_and_its_update_match_jax():
    rng = np.random.RandomState(5)
    book = rng.randn(16, 6).astype(np.float32)
    x = rng.randn(2, 3, 4, 6).astype(np.float32)
    cluster = rng.rand(16).astype(np.float32)
    avg = (book + 0.1 * rng.randn(16, 6)).astype(np.float32)
    jstate = jvq.VQState(jnp.asarray(book), jnp.asarray(cluster), jnp.asarray(avg))
    q_j, idx_j, loss_j, new_j = jvq.vector_quantize(jstate, jnp.asarray(x))
    tstate = tvq.VQState(*(torch.from_numpy(a.copy()) for a in (book, cluster, avg)))
    xt = torch.from_numpy(x).requires_grad_(True)
    q, idx, loss, new = tvq.vector_quantize(tstate, xt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _close(q.detach(), q_j)
    _close(loss.detach(), loss_j)
    for got, want in zip(new, new_j):
        _close(got, want)
    # straight through: the gradient reaches x unchanged
    (g,) = torch.autograd.grad(q.sum(), xt)
    assert torch.equal(g, torch.ones_like(g))
    # without update the state is returned as it was
    assert tvq.vector_quantize(tstate, xt, update=False)[3] is tstate


@pytest.mark.parametrize("arch", ["old", "new"])
def test_discriminator_with_fq_layers_matches_jax(arch):
    """The quantize layer after block 1: scores, the commitment loss the
    JAX package sows, the trunk features, and the codebook after the EMA
    update of one batch."""
    modules, params, model = _pair(arch, fq_layers=(2,), fq_dict_size=32)
    x = _inputs(6)["x"]
    probs = np.random.RandomState(7).dirichlet([1.0, 1.0], size=3).astype(np.float32)
    variables = {"params": params["D"], "vq": params["D_vq"]}
    args = (jnp.asarray(x),) + ((jnp.asarray(probs),) if arch == "new" else ())
    scores_j, inter = modules.D.apply(variables, *args, mutable=["intermediates"])
    (loss_j,) = jax.tree.leaves(inter["intermediates"])
    feats_j = modules.D.apply(variables, jnp.asarray(x), return_features=True)
    _, upd = modules.D.apply(variables, *args, mutable=["vq"])
    p = torch.from_numpy(probs) if arch == "new" else None
    with torch.no_grad():
        scores, loss = model.D(_nchw(x), p, return_q_loss=True)
        feats = model.D(_nchw(x), return_features=True)
        model.D(_nchw(x), p, update_vq=True)
    _close(scores, scores_j)
    _close(loss, loss_j)
    # the port flattens (C, 2, 2), the JAX package (2, 2, C)
    c = feats.shape[1] // 4
    _close(feats.reshape(3, c, 2, 2).permute(0, 2, 3, 1).reshape(3, -1), feats_j)
    vq = model.D.quantize_blocks[1]
    for name, key in (("codebook", "codebook1"), ("cluster_size", "cluster1"),
                      ("embed_avg", "avg1")):
        _close(getattr(vq, name), upd["vq"][key])
    assert not np.allclose(vq.codebook.numpy(), np.asarray(params["D_vq"]["codebook1"]))


# ------------------------------------------------------------- contrastive


def test_nt_xent_loss_matches_jax():
    rng = np.random.RandomState(8)
    h1, h2 = rng.randn(4, 12).astype(np.float32), rng.randn(4, 12).astype(np.float32)
    _close(tcl.nt_xent_loss(torch.from_numpy(h1), torch.from_numpy(h2)),
           jcl.nt_xent_loss(jnp.asarray(h1), jnp.asarray(h2)))


def jax_view_draws(key, n, size):
    """``contrastive_views``' draws (key split 4-way: ops and flip of view
    1, then of view 2) as the port's two gated-on AugmentDraws."""
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def view(k_ops, k_flip):
        flip = bool(jax.random.bernoulli(k_flip, 0.5))
        return taug.AugmentDraws(torch.ones(n, dtype=torch.bool), torch.full((n,), flip),
                                 jax_pipeline_draws(k_ops, n, size, tcl.VIEW_TYPES))

    return view(k1, k2), view(k3, k4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contrastive_d_loss_matches_jax(seed):
    modules, params, model = _pair("old")
    x = _inputs(9 + seed, batch=4)["x"]
    key = jax.random.PRNGKey(seed)
    feats_j = lambda im: modules.D.apply({"params": params["D"]}, im, return_features=True)
    want = jcl.contrastive_d_loss(feats_j, key, jnp.asarray(x))
    with torch.no_grad():
        got = tcl.contrastive_d_loss(lambda im: model.D(im, return_features=True), _nchw(x),
                                     jax_view_draws(key, 4, 16))
    _close(got, want)


# ---------------------------------------------------------- debug encoders


@pytest.mark.parametrize("name", ["DebugEncoder", "PhillipEncoder", "PhillipEncoder64"])
def test_debug_encoders_match_jax(name):
    """Selected by ``encoder_class``; at 32px, with the 514-wide latent that
    their 512-wide encodings need."""
    modules, params, model = _pair("old", image_size=32, latent_dim=514, encoder_dim=512,
                                   encoder_class=name)
    assert type(model.encoder).__name__ == name
    x = _inputs(12, latent=514, size=32)["x"]
    with torch.no_grad():
        got = model.encode(_nchw(x))
    assert got.shape == (3, 512)
    _close(got, modules.encode(params, jnp.asarray(x)))
