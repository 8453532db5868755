"""PyTorch port: interlaced input through the models and the consumers
against the JAX package on CPU, bit for bit (inputs and JAX side:
tests/torch_port_reference.py, load_exact): degrain_clip with fields=True,
tff=True on the lockstep engine (radius 2, so both shifted and unshifted
pairs occur), flowfps_clip with fields=True (no shift applied, as in the
JAX package) on the exact engine, and Compensate with a field shift of +-1
on tests/torch_flow_cases.py's inputs (Flow with a shift:
test_torch_flow_consumers.py).  degrain_clip with fields=True on the exact
engine is held to the JAX package's, and frame by frame to degrain_n_frame
with the pairs' shifts."""
import dataclasses
import os
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_flow_cases as tfc  # noqa: E402
import torch_port_reference as tpr  # noqa: E402
from mvtools_tpu_torch import compensate  # noqa: E402
from mvtools_tpu_torch import convert  # noqa: E402
from mvtools_tpu_torch.core import config, fields, types  # noqa: E402
from mvtools_tpu_torch.degrain import DegrainConfig  # noqa: E402
from mvtools_tpu_torch.flowfps import FlowFPSConfig  # noqa: E402
from mvtools_tpu_torch.models.denoise import (  # noqa: E402
    degrain_clip, degrain_n_frame)
from mvtools_tpu_torch.models.frc import flowfps_clip  # noqa: E402
from mvtools_tpu_torch.super import build_super  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_exact(tmp_path_factory)


def test_degrain_clip_fields_matches_jax(ref):
    fmt, scfg, acfg = tpr.exact_model_specs(config, types, "GRAY",
                                            tpr.EX_FIELDS_ACFG)
    gray = torch.from_numpy(tpr.make_exact_gray(frames=4))
    got = degrain_clip([gray], fmt, scfg, acfg,
                       DegrainConfig(**tpr.EX_DEGRAIN), tpr.EX_RADIUS,
                       engine="lockstep")[0]
    np.testing.assert_array_equal(got.numpy(), ref["fdc_lockstep"])
    with pytest.raises(ValueError, match="tff"):
        degrain_clip([gray], fmt, scfg, dataclasses.replace(acfg, tff=None),
                     DegrainConfig(**tpr.EX_DEGRAIN), tpr.EX_RADIUS,
                     engine="lockstep")


def test_degrain_clip_fields_exact_matches_jax(ref):
    fmt, scfg, acfg = tpr.exact_model_specs(config, types, "GRAY",
                                            tpr.EX_FIELDS_ACFG)
    gray = torch.from_numpy(tpr.make_exact_gray(frames=4))
    got = degrain_clip([gray], fmt, scfg, acfg,
                       DegrainConfig(**tpr.EX_DEGRAIN), tpr.EX_RADIUS,
                       engine="exact")[0]
    np.testing.assert_array_equal(got.numpy(), ref["fdc_exact"])


def test_degrain_clip_fields_exact_is_degrain_n_frame():
    """degrain_clip(fields=True, engine="exact"): each frame is
    degrain_n_frame(engine="exact") from its neighbours with the pairs'
    field shifts (core.fields.field_shift, held to the JAX package's in
    test_torch_fields_analyse.py); the shifts change the fields."""
    fmt, scfg, acfg = tpr.exact_model_specs(config, types, "GRAY",
                                            tpr.EX_FIELDS_ACFG)
    sspec = scfg.validate(fmt)
    aspec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
    aspec_f = dataclasses.replace(acfg, isb=False).validate(sspec)
    gray = torch.from_numpy(tpr.make_exact_gray(frames=4))
    dcfg = DegrainConfig(**tpr.EX_DEGRAIN)
    r, total = tpr.EX_RADIUS, gray.shape[0]
    info = {}
    got = degrain_clip([gray], fmt, scfg, acfg, dcfg, r, engine="exact",
                       info=info)[0]

    def at(t):
        return [gray[min(max(t, 0), total - 1)]]

    ks = range(1, r + 1)
    for t in range(total):
        want = degrain_n_frame(
            at(t), [at(t - k) for k in ks], [at(t + k) for k in ks], sspec,
            aspec_b, aspec_f, dcfg, engine="exact",
            valid_b=[t + k < total for k in ks],
            valid_f=[t - k >= 0 for k in ks],
            field_shift_b=[fields.field_shift(t, t + k, 2, True, True)
                           for k in ks],
            field_shift_f=[fields.field_shift(t, t - k, 2, True, True)
                           for k in ks])[0]
        assert torch.equal(got[t], want), f"frame {t}"
    plain = {}
    degrain_clip([gray], fmt, scfg, dataclasses.replace(acfg, fields=False),
                 dcfg, r, engine="exact", info=plain)
    assert not torch.equal(plain["fields_b"].levels[0].y,
                           info["fields_b"].levels[0].y)


def test_flowfps_clip_fields_matches_jax(ref):
    fmt, scfg, acfg = tpr.exact_model_specs(config, types, "GRAY",
                                            tpr.EX_FIELDS_ACFG)
    got = flowfps_clip([tpr.make_exact_gray()], fmt, Fraction(30),
                       Fraction(60), scfg, acfg, FlowFPSConfig(maskmode=2),
                       engine="exact", device="cpu")
    np.testing.assert_array_equal(
        torch.stack([f[0] for f in got]).numpy(), ref["fps"])


def _shift_inputs(ref):
    """The port's supers, source planes, field and meta of
    torch_flow_cases' first configuration, on the reference's field."""
    family, w, h, pel, blk, ov = tfc.CONFIGS[0]
    from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig
    fmt = types.VideoFormat(w, h, 8, types.ColorFamily[family])
    sspec = SuperConfig(pel=pel, chroma=False).validate(fmt)
    aspec = AnalyseConfig(blksize=blk, overlap=ov, truemotion=True,
                          chroma=False, isb=True).validate(sspec)
    planes = tfc.frames(np.random.default_rng(w), 2, w, h, family=family)
    sups = [build_super([torch.from_numpy(p) for p in f], sspec)
            for f in planes]
    meta = convert.analysis_meta_from_dict(dataclasses.asdict(
        dataclasses.replace(aspec.meta, is_backward=True)))
    arrays = [ref[f"shift_field_{k}"] for k in ("x", "y", "sad")]
    mv = _port_field(arrays, meta)
    return sups, [torch.from_numpy(p) for p in planes[0]], mv, meta


def _port_field(arrays, meta):
    from mvtools_tpu_torch.core.types import MVField, MVPlaneField
    return MVField((MVPlaneField(*(torch.from_numpy(a) for a in arrays)),),
                   torch.tensor(1, dtype=torch.int32), meta)


@pytest.mark.parametrize("shift", list(tpr.EX_FS))
def test_compensate_field_shift_matches_jax(ref, shift):
    sups, _, mv, meta = _shift_inputs(ref)
    got = compensate.compensate(sups[0], sups[1], mv, meta,
                                compensate.CompensateConfig(),
                                field_shift=shift)
    np.testing.assert_array_equal(torch.stack(list(got)).numpy(),
                                  ref[f"comp_{shift}"])
