"""PyTorch port: the probe-only level search at pel 4 through analyse_batch
on single-level analyses (torch_port_reference.load_pel4()'s P4_SINGLE),
two jobs with a flashing region, against the JAX package bit for bit: gray
with the DCT costs dct 1 and dct 2 (the candidates' blocks through the
per-block fetch at pel 4), YUV420 with the SATD cost dct 5 (the three-stat
probes on 16-subplane stacks, chroma SADs beside them) and YUV420 at 16
bits (the uint16 probes, luma and chroma); and FlowFPS at pel 4 on synthetic seeded fields
(tests/torch_flow_cases.py), maskmode 0 and 2."""
import os
import sys

import numpy as np
import pytest

import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mvtools_tpu import flowfps as jfps
from mvtools_tpu_torch import analyse_batch, flowfps
from mvtools_tpu_torch.core import config as pconfig
from mvtools_tpu_torch.core import types as ptypes
from mvtools_tpu_torch.super import build_super

import torch_flow_cases as tfc
import torch_port_reference as tpr
from test_torch_pel4_slice import assert_field  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_pel4(tmp_path_factory)


@pytest.mark.parametrize("name", list(tpr.P4_SINGLE))
def test_pel4_single_level(ref, name):
    planes = tpr.p4_single_planes(name)
    sspec, aspec = tpr.p4_configs(pconfig, ptypes, name)
    sups = build_super([torch.from_numpy(p) for p in planes], sspec)
    got = analyse_batch(sups.map(lambda a: a[[1, 1]]),
                        sups.map(lambda a: a[[2, 0]]), aspec)
    assert_field(got, ref, f"{name}_")


@pytest.mark.parametrize("maskmode", [0, 2])
def test_pel4_flowfps_frame(maskmode):
    """flowfps_frame on pel-4 supers built by each package (held equal)
    and seeded fields, at time256 64 and 200."""
    import jax.numpy as jnp
    s = tfc.setup(("GRAY", 64, 48, 4, 8, 0))
    fields = dict(mv_b=tfc.make_fields(s, True, 0.0),
                  mv_f=tfc.make_fields(s, False, 0.0))
    if maskmode == 2:
        fields.update(mv_bb=tfc.make_fields(s, True, 0.0),
                      mv_ff=tfc.make_fields(s, False, 0.0))
    meta, tmeta = tfc.meta_pair(s["aspec"], True)
    src, rf = s["planes"]
    for time256 in (64, 200):
        jf = {k: v[0] for k, v in fields.items()}
        tf = {k: v[1] for k, v in fields.items()}
        want = jfps.flowfps_frame(
            [jnp.asarray(p) for p in src], [jnp.asarray(p) for p in rf],
            *s["jsups"], jf.pop("mv_b"), jf.pop("mv_f"), meta,
            jfps.FlowFPSConfig(maskmode=maskmode), time256, **jf)
        got = flowfps.flowfps_frame(
            [torch.from_numpy(p) for p in src],
            [torch.from_numpy(p) for p in rf], *s["tsups"], tf.pop("mv_b"),
            tf.pop("mv_f"), tmeta, flowfps.FlowFPSConfig(maskmode=maskmode),
            time256, **tf)
        tfc.equal(got, want, f"maskmode {maskmode} t{time256}")
        assert not np.array_equal(got[0].numpy(), src[0])
