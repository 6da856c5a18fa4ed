"""PyTorch port: ``models/encoders.py`` held against the JAX package's.

Offsets, lattice points and per-offset index pairs must be equal; the
encoders' output patterns (COO rows and columns, CSR row pointers)
equal, and their values and the gradient of a weighted sum of them
equal to float32 rounding (``rtol=1e-6, atol=1e-7``: both only move
values).  Inputs are numpy arrays from fixed seeds, handed to both
packages.
"""

import doctest
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu.models.encoders as jenc
import torchsparsegradutils_tpu_torch.models.encoders as penc
from torchsparsegradutils_tpu_torch.models import (
    PairwiseEncoder, calc_pairwise_coo_indices_nd)

TOL = dict(rtol=1e-6, atol=1e-7)

CONFIGS = [  # radius, volume, diag, upper, relation
    (1.0, (1, 5, 4), False, False, "indep"),
    (1.5, (1, 4, 5), True, None, "indep"),
    (1.5, (2, 4, 5), True, True, "intra"),
    (2.0, (1, 6, 6), False, None, "indep"),
    (1.0, (3, 3, 4, 3), True, None, "inter"),
    (1.5, (1, 4, 3, 5), False, False, "indep"),
    (1.7, (2, 3, 3, 3), False, True, "inter"),
]
IDS = [f"r{c[0]}-{'x'.join(map(str, c[1]))}-diag{c[2]}-upper{c[3]}-{c[4]}"
       for c in CONFIGS]


def _values(enc, seed, batch=()):
    shape = batch + (len(enc.offsets),) + enc.volume_shape
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(cfg, layout):
    radius, vol, diag, upper, rel = cfg
    kw = dict(diag=diag, upper=upper, channel_voxel_relation=rel,
              layout=layout)
    return (PairwiseEncoder(radius, vol, **kw),
            jenc.PairwiseEncoder(radius, vol, **kw))


def _same_pattern(P, ref, layout, batch=()):
    """P's pattern is the one JAX encoder ``ref`` gives its output."""
    if layout == "coo":
        np.testing.assert_array_equal(P.rows(), ref._out_rows)
    else:
        np.testing.assert_array_equal(P.indptr_np(), ref.crow_indices)
    np.testing.assert_array_equal(P.cols(), ref._out_cols)
    assert P.shape == batch + (ref.volume_numel,) * 2


def _jax_values(ref, v, w=None):
    """The JAX encoder's output values, and with ``w`` the gradient of
    their ``w``-weighted sum, under one jit."""
    def run(x, w):
        out, vjp = jax.vjp(lambda x: ref(x).data, x)
        return out, (None if w is None else vjp(w)[0])
    return [None if t is None else np.asarray(t)
            for t in jax.jit(run)(jnp.asarray(v), w)]


@pytest.mark.parametrize("radius,dims,upper,channels,relation", [
    (1.0, 1, None, 1, "indep"), (2.0, 1, False, 1, "indep"),
    (1.5, 2, None, 1, "indep"), (1.5, 2, True, 1, "indep"),
    (1.0, 2, None, 2, "intra"), (1.0, 2, False, 3, "inter"),
    (1.5, 3, False, 1, "indep"), (2.3, 3, None, 2, "inter"),
])
def test_coords_and_offsets_match_jax(radius, dims, upper, channels,
                                      relation):
    assert penc._gen_coords_nd(radius, dims) == jenc._gen_coords_nd(
        radius, dims)
    assert penc._gen_offsets_nd(radius, dims, upper, channels, relation) == \
        jenc._gen_offsets_nd(radius, dims, upper, channels, relation)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_pairwise_indices_match_jax(cfg):
    radius, vol, diag, upper, rel = cfg
    got = calc_pairwise_coo_indices_nd(radius, vol, diag, upper, rel)
    ref = jenc.calc_pairwise_coo_indices_nd(radius, vol, diag, upper, rel)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_encoder_matches_jax(cfg, layout):
    enc, ref = _pair(cfg, layout)
    assert enc.offsets == ref.offsets and enc.nnz == ref.nnz
    v = _values(enc, len(enc.offsets))
    w = np.random.default_rng(1).standard_normal(enc._out_nnz).astype(
        np.float32)
    vt = torch.from_numpy(v).requires_grad_(True)
    P = enc(vt)
    (gv,) = torch.autograd.grad(P.values, vt, torch.from_numpy(w))
    J, gJ = _jax_values(ref, v, w)
    _same_pattern(P, ref, layout)
    np.testing.assert_allclose(P.values.detach().numpy(), J, **TOL)
    np.testing.assert_allclose(gv.numpy(), gJ, **TOL)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_encoder_batched_matches_jax(layout):
    enc, ref = _pair(CONFIGS[1], layout)
    v = _values(enc, 7, batch=(3,))
    P = enc(torch.from_numpy(v))
    _same_pattern(P, ref, layout, (3,))
    assert P.values.shape == (3, enc._out_nnz)
    np.testing.assert_allclose(P.values.numpy(), _jax_values(ref, v)[0],
                               **TOL)


def test_encoder_dense_product_matches_jax():
    """The flagship factor's product through the port's sparse_mm, as the
    train step uses it, against the JAX encoder's dense matrix."""
    from torchsparsegradutils_tpu_torch import sparse_mm
    enc, ref = _pair(CONFIGS[5], "coo")
    v = _values(enc, 3)
    x = np.random.default_rng(4).standard_normal(
        (enc.volume_numel, 2)).astype(np.float32)
    got = sparse_mm(enc(torch.from_numpy(v)).T, torch.from_numpy(x))
    dense = np.asarray(ref(jnp.asarray(v)).todense())
    np.testing.assert_allclose(got.numpy(), dense.T @ x, rtol=1e-5,
                               atol=1e-6)


def test_duplicate_pairs_merge_as_in_jax(monkeypatch):
    """A repeated offset block makes duplicate (row, col) pairs: both
    encoders sum them into one entry."""
    def doubled(module):
        orig = module.calc_pairwise_coo_indices_nd

        def calc(*a, **k):
            d = orig(*a, **k)
            first = next(iter(d))
            return {**d, "again": d[first]}
        monkeypatch.setattr(module, "calc_pairwise_coo_indices_nd", calc)

    for module in (penc, jenc):
        doubled(module)
    for layout in ("coo", "csr"):
        enc, ref = _pair(CONFIGS[0], layout)
        assert enc._has_duplicates and ref._has_duplicates
        enc.offsets[-1] = ref.offsets[-1] = enc.offsets[0]
        v = _values(enc, 5)
        P = enc(torch.from_numpy(v))
        _same_pattern(P, ref, layout)
        assert P.nnz == enc._out_nnz < enc.nnz
        np.testing.assert_allclose(P.values.numpy(), _jax_values(ref, v)[0],
                                   **TOL)


def test_voxel_encoder_and_deprecated_indices_match_jax():
    with pytest.warns(DeprecationWarning):
        enc = penc.PairwiseVoxelEncoder(1.0, (1, 3, 4, 3), diag=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = jenc.PairwiseVoxelEncoder(1.0, (1, 3, 4, 3), diag=True)
        rid = jenc.calc_pairwise_coo_indices(1.5, (1, 3, 3, 3))
    v = _values(enc, 9)
    P = enc(torch.from_numpy(v))
    _same_pattern(P, ref, "coo")
    np.testing.assert_allclose(P.values.numpy(), _jax_values(ref, v)[0],
                               **TOL)
    with pytest.warns(DeprecationWarning):
        got = penc.calc_pairwise_coo_indices(1.5, (1, 3, 3, 3))
    assert list(got) == list(rid)
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match=r"\(C, H, D, W\)"):
        penc.PairwiseVoxelEncoder(1.0, (1, 3, 3))
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="4D tuple"):
        penc.calc_pairwise_coo_indices(1.0, (1, 3, 3))


@pytest.mark.parametrize("call,msg", [
    (lambda e: e(torch.ones(3, 4)), "dimensions"),
    (lambda e: e(torch.ones(len(e.offsets), 1, 5, 5)), "Spatial dimensions"),
    (lambda e: e(torch.ones(len(e.offsets) + 1, 1, 4, 4)),
     "number of offsets"),
    (lambda e: e(torch.ones(len(e.offsets), 1, 4, 4, dtype=torch.int64)),
     "floating dtype"),
    (lambda e: PairwiseEncoder(1.0, (1, 4, 4), layout="bsr"), "layout"),
    (lambda e: PairwiseEncoder(1.0, (1, 4, 4), index_dtype=np.int16),
     "index_dtype"),
    (lambda e: calc_pairwise_coo_indices_nd(0.5, (1, 3, 3)), "radius"),
    (lambda e: calc_pairwise_coo_indices_nd(1.0, (1, 3, 3),
                                            channel_voxel_relation="intra"),
     "indep"),
    (lambda e: calc_pairwise_coo_indices_nd(1.0, (3,)), "volume_shape"),
    (lambda e: penc._gen_coords_nd(1.0, 0), "spatial_dims"),
])
def test_encoder_validation(call, msg):
    with pytest.raises(ValueError, match=msg):
        call(PairwiseEncoder(1.0, (1, 4, 4)))


def test_encoder_follows_the_values_device_and_dtype():
    enc = PairwiseEncoder(1.0, (1, 4, 4), layout="csr")
    L = enc(torch.ones(len(enc.offsets), 1, 4, 4, dtype=torch.float64))
    assert L.values.dtype == torch.float64 and L.device.type == "cpu"
    assert L.indptr.dtype == np.int32


def test_docstring_examples():
    result = doctest.testmod(penc, optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0
