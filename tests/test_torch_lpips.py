"""The port's LPIPS against the JAX package's, on the CPU.

The JAX package's seeded random backbone goes through
``lpips_params_from_jax``; the same numpy images go through both. float32,
rtol 1e-4 / atol 1e-6: five convolutions sum in another order. Also the
reading of a local ``lpips.LPIPS(net='alex')``-layout state dict, against
the JAX package's converter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu.models import lpips as jlpips
from stylex_tpu_torch.models import lpips as tlpips
from stylex_tpu_torch.models.convert import lpips_params_from_jax

torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def params():
    jp = jlpips.init_lpips_params(jax.random.PRNGKey(1))
    return jp, lpips_params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("size", [16, 64])
def test_lpips_distance_matches_jax(params, size):
    """16px is upsampled to 32 on both sides; 64px runs as it is."""
    jp, tp = params
    rng = np.random.RandomState(size)
    x, y = (rng.rand(2, size, size, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    want = np.asarray(jlpips.lpips_distance(jp, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = tlpips.lpips_distance(tp, _nchw(x), _nchw(y)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def _lpips_package_state_dict(seed=0):
    """Random weights in ``lpips.LPIPS(net='alex')``'s key layout."""
    rng = np.random.RandomState(seed)
    sd, in_ch = {}, 3
    for i, ((out_ch, k, _, _), idx) in enumerate(zip(tlpips.LPIPS_CFG, (0, 3, 6, 8, 10))):
        key = f"net.slice{i + 1}.{idx}"
        sd[f"{key}.weight"] = torch.from_numpy(rng.randn(out_ch, in_ch, k, k).astype(np.float32))
        sd[f"{key}.bias"] = torch.from_numpy(rng.randn(out_ch).astype(np.float32))
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(rng.rand(1, out_ch, 1, 1).astype(np.float32))
        in_ch = out_ch
    return sd


def test_lpips_state_dict_reads_like_jax(tmp_path):
    sd = _lpips_package_state_dict()
    want = jlpips.convert_lpips_state_dict(sd)
    path = tmp_path / "alex.pt"
    torch.save(sd, path)
    got = tlpips.load_lpips_params(str(path), device="cpu")
    from_jax = lpips_params_from_jax(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(from_jax)
    for k, v in from_jax.items():
        if isinstance(v, dict):
            for kk in v:
                assert torch.equal(got[k][kk], v[kk]), (k, kk)
        else:
            assert torch.equal(got[k], v), k
    with pytest.raises(FileNotFoundError):
        tlpips.load_lpips_params(str(tmp_path / "missing.pt"))
    with pytest.raises(ValueError, match="no conv matching"):
        tlpips.convert_lpips_state_dict({k: v for k, v in sd.items() if "lin" in k})
