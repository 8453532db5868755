"""PyTorch port: Degrain1 against the JAX package, bit for bit, fed the
JAX package's MV fields and pyramids through convert.py so the module is
held alone.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the pipeline is integer;
its float64 islands truncate to the same integers)."""
import json
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mvtools_tpu  # noqa: F401  (enables x64)
from mvtools_tpu import degrain as jax_degrain

from mvtools_tpu_torch import convert
from mvtools_tpu_torch.core.thscd import is_usable, scale_thscd
from mvtools_tpu_torch.degrain import (DegrainConfig, _degrain_weight,
                                       _normalise_weights, degrain)

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load(tmp_path_factory)


def _jax_state(ref, device="cpu"):
    sspec, aspec = tpr.specs(ref)
    meta = json.loads(str(ref["aspec_json"]))["meta"]
    sups = convert.super_from_numpy(
        [[ref[f"super{lv}"] for lv in range(tpr.LEVELS)]], sspec, device)
    mvb = convert.mvfield_from_numpy(
        [(ref[f"mv_x{lv}"], ref[f"mv_y{lv}"], ref[f"mv_sad{lv}"])
         for lv in range(tpr.LEVELS)], meta, device)
    return sspec, aspec, sups, mvb


def _job(mvb, j):
    from mvtools_tpu_torch.core.types import MVField, MVPlaneField
    return MVField(tuple(MVPlaneField(l.x[j], l.y[j], l.sad[j])
                         for l in mvb.levels), mvb.validity[j], mvb.meta)


@pytest.mark.parametrize("i", range(tpr.N_FRAMES - 2 * tpr.RADIUS))
def test_degrain_matches_jax_per_frame(ref, i):
    """One output frame at a time, unbatched, as the JAX side ran it."""
    sspec, aspec, sups, mvb = _jax_state(ref)
    c = i + tpr.RADIUS
    out = degrain([torch.from_numpy(ref["frames"][c])],
                  [sups.map(lambda a: a[c + 1]), sups.map(lambda a: a[c - 1])],
                  [_job(mvb, 2 * i), _job(mvb, 2 * i + 1)], aspec.meta,
                  DegrainConfig(thsad=400))[0]
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref["degrain"][i])


def test_degrain_batched_matches_jax(ref):
    """All output frames in one batched call."""
    sspec, aspec, sups, mvb = _jax_state(ref)
    nb = tpr.N_FRAMES - 2 * tpr.RADIUS
    cs = torch.arange(tpr.RADIUS, tpr.RADIUS + nb)
    out = degrain([torch.from_numpy(ref["frames"])[cs]],
                  [sups.map(lambda a: a[cs + 1]),
                   sups.map(lambda a: a[cs - 1])],
                  [_job(mvb, slice(0, None, 2)), _job(mvb, slice(1, None, 2))],
                  aspec.meta, DegrainConfig(thsad=400))[0]
    np.testing.assert_array_equal(out.numpy(), ref["degrain"])


def test_degrain_changes_pixels_and_respects_limit(ref):
    sspec, aspec, sups, mvb = _jax_state(ref)
    src = torch.from_numpy(ref["frames"][1])
    args = ([src], [sups.map(lambda a: a[2]), sups.map(lambda a: a[0])],
            [_job(mvb, 0), _job(mvb, 1)], aspec.meta)
    free = degrain(*args, DegrainConfig(thsad=10000, thscd1=1000,
                                        thscd2=255))[0]
    lim = degrain(*args, DegrainConfig(thsad=10000, thscd1=1000, thscd2=255,
                                       limit=2))[0]
    d_free = (free.int() - src.int()).abs().max().item()
    assert d_free > 2
    assert (lim.int() - src.int()).abs().max().item() == 2


def test_degrain_weights_match_jax():
    """The float64 islands: DegrainWeight and normaliseWeights."""
    rng = np.random.default_rng(11)
    sad = rng.integers(0, 4000, (3, 7, 9)).astype(np.int64)
    sad[0, 0, :3] = (0, 1599, 1600)
    ws = []
    for k in range(2):
        w = _degrain_weight(1600, torch.from_numpy(sad + 37 * k))
        want = jax_degrain._degrain_weight(1600, jnp.asarray(sad + 37 * k))
        np.testing.assert_array_equal(w.numpy(), np.asarray(want))
        ws.append(w.to(torch.int32))
    wsrc, wrefs = _normalise_weights(ws)
    jsrc, jrefs = jax_degrain._normalise_weights(
        [jnp.asarray(w.numpy()) for w in ws])
    np.testing.assert_array_equal(wsrc.numpy(), np.asarray(jsrc))
    for a, b in zip(wrefs, jrefs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_usability_gate_matches_jax(ref):
    from mvtools_tpu.core import thscd as jax_thscd
    from mvtools_tpu.core.types import AnalysisMeta as JaxMeta
    sspec, aspec, sups, mvb = _jax_state(ref)
    meta_d = json.loads(str(ref["aspec_json"]))["meta"]
    assert scale_thscd(400, 130, aspec.meta) == jax_thscd.scale_thscd(
        400, 130, JaxMeta(**meta_d))
    for th1 in (1600, 30000, 60000):
        got = is_usable(mvb, th1, 2)
        want = [(int((ref["mv_sad0"][j] > th1).sum()) <= 2)
                for j in range(got.shape[0])]
        assert got.tolist() == want


def test_degrain_unported_options_raise(ref):
    import dataclasses
    sspec, aspec, sups, mvb = _jax_state(ref)
    src = torch.from_numpy(ref["frames"][1])
    refs = [sups.map(lambda a: a[2]), sups.map(lambda a: a[0])]
    ov = dataclasses.replace(aspec.meta, overlap_x=8, overlap_y=8)
    mvs = [_job(mvb, 0), _job(mvb, 1)]
    for m in mvs:
        m.meta = ov
    with pytest.raises(NotImplementedError, match="overlap"):
        degrain([src], refs, mvs, ov, DegrainConfig())
    with pytest.raises(NotImplementedError, match="chroma"):
        degrain([src, src, src], refs, [_job(mvb, 0), _job(mvb, 1)],
                aspec.meta, DegrainConfig())
