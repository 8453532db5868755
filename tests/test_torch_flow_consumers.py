"""PyTorch port: the Flow family's other consumers (flowinter.py, flow.py,
flowblur.py, blockfps.py) against the JAX package on the same inputs, bit
for bit (tolerance 0): supers from build_super in each package, synthetic
seeded fields (smooth vectors with noise, SADs over and under the
scene-change thresholds), gray and YUV420 with overlap and a block grid
padded to the frame.  BlockFPS also with vectors that send its
motion-compensated fetches outside the padded stack."""
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mvtools_tpu import blockfps as jbf
from mvtools_tpu import flow as jflow
from mvtools_tpu import flowblur as jblur
from mvtools_tpu import flowinter as jfi
from mvtools_tpu_torch import blockfps, flow, flowblur, flowinter

import torch_flow_cases as tfc


@pytest.fixture(scope="module")
def setups():
    return [tfc.setup(c) for c in tfc.CONFIGS]


def _planes(s, i):
    return ([jnp.asarray(p) for p in s["planes"][i]],
            [torch.from_numpy(p) for p in s["planes"][i]])


def _split(fields):
    return ({k: v[0] for k, v in fields.items()},
            {k: v[1] for k, v in fields.items()})


def test_flowinter_matches_jax(setups):
    """time 25, 50 and 80; usable fields and a scene change (blend, and
    with blend=False the source frame); the extra fields, usable or not."""
    for s in setups:
        (jsrc, tsrc), (jref, tref) = _planes(s, 0), _planes(s, 1)
        meta, tmeta = tfc.meta_pair(s["aspec"], True)
        mk = tfc.make_fields
        base = dict(mv_b=mk(s, True, 0.0), mv_f=mk(s, False, 0.0))
        cases = [(base, {}),
                 (dict(mv_b=mk(s, True, 0.9), mv_f=mk(s, False, 0.0)), {}),
                 (dict(mv_b=mk(s, True, 0.0), mv_f=mk(s, False, 0.9)),
                  dict(blend=False)),
                 (dict(base, mv_bb=mk(s, True, 0.0), mv_ff=mk(s, False, 0.0)),
                  {}),
                 (dict(base, mv_bb=mk(s, True, 0.9), mv_ff=mk(s, False, 0.0)),
                  {})]
        for fields, kw in cases:
            jf, tf = _split(fields)
            for time in (25.0, 50.0, 80.0):
                want = jfi.flowinter(jsrc, jref, *s["jsups"], jf["mv_b"],
                                     jf["mv_f"], meta,
                                     jfi.FlowInterConfig(time=time, **kw),
                                     jf.get("mv_bb"), jf.get("mv_ff"))
                got = flowinter.flowinter(tsrc, tref, *s["tsups"],
                                          tf["mv_b"], tf["mv_f"], tmeta,
                                          flowinter.FlowInterConfig(time=time,
                                                                    **kw),
                                          tf.get("mv_bb"), tf.get("mv_ff"))
                tfc.equal(got, want, f"{s['cfg']} {sorted(fields)} {kw} "
                          f"time {time}")


@pytest.mark.parametrize("mode", [0, 1], ids=["fetch", "shift"])
def test_flow_matches_jax(setups, mode):
    """Fetch and shift (the raster-order scatter, last write wins) at time
    100, 50 and 30, with a field shift, and on a scene change."""
    for s in setups:
        jsrc, tsrc = _planes(s, 0)
        for backward in (False, True):
            meta, tmeta = tfc.meta_pair(s["aspec"], backward)
            for sad_hi, time, shift in ((0.0, 100.0, 0), (0.0, 50.0, 1),
                                        (0.0, 30.0, 0), (0.9, 100.0, 0)):
                jf, tf = tfc.make_fields(s, backward, sad_hi, spread=6)
                cfg = dict(mode=mode, time=time)
                want = jflow.flow(jsrc, s["jsups"][1], jf, meta,
                                  jflow.FlowConfig(**cfg), shift)
                got = flow.flow(tsrc, s["tsups"][1], tf, tmeta,
                                flow.FlowConfig(**cfg), shift)
                tfc.equal(got, want, f"{s['cfg']} {cfg} shift {shift}")


def test_flowblur_matches_jax(setups):
    """blur 50 and 200, prec 1 and 3, the default step bound and a bound
    of 4 that cuts long paths; and a scene change."""
    for s in setups:
        jsrc, tsrc = _planes(s, 0)
        meta, tmeta = tfc.meta_pair(s["aspec"], True)
        for blur, prec, steps, sad_hi in ((50.0, 1, 128, 0.0),
                                          (200.0, 3, 128, 0.0),
                                          (200.0, 1, 4, 0.0),
                                          (50.0, 1, 128, 0.9)):
            jb, tb = tfc.make_fields(s, True, sad_hi, spread=6)
            jf, tf = tfc.make_fields(s, False, 0.0, spread=6)
            kw = dict(blur=blur, prec=prec, max_steps=steps)
            want = jblur.flowblur(jsrc, s["jsups"][0], jb, jf, meta,
                                  jblur.FlowBlurConfig(**kw))
            got = flowblur.flowblur(tsrc, s["tsups"][0], tb, tf, tmeta,
                                    flowblur.FlowBlurConfig(**kw))
            tfc.equal(got, want, f"{s['cfg']} {kw} {sad_hi}")


@pytest.mark.parametrize("modes", [(0, 1, 2, 3, 4), (5, 6, 7, 8)],
                         ids=["modes0-4", "modes5-8"])
def test_blockfps_matches_jax(setups, modes):
    """Each mode at time256 64 and 200 on usable fields; time256 128 on
    fields whose vectors reach past the padded stack (the fetch's start is
    taken as a window slice takes it), on a scene change and with
    blend=False."""
    for s in setups:
        (jsrc, tsrc), (jref, tref) = _planes(s, 0), _planes(s, 1)
        meta, tmeta = tfc.meta_pair(s["aspec"], True)
        mk = tfc.make_fields
        near = (mk(s, True, 0.0), mk(s, False, 0.0))
        far = (mk(s, True, 0.0, base=(-300, 250), spread=60),
               mk(s, False, 0.0, base=(280, -260), spread=60))
        # at time256 128 the far fetches start up to 180 pel left of and
        # above the frame, past the super's padding
        m = s["aspec"].meta
        assert int(far[0][1].levels[0].x.min()) // 2 < -m.hpadding * m.pel
        cut = (mk(s, True, 0.9), mk(s, False, 0.0))
        runs = [(near, t, {}) for t in (64, 200)] + [
            (far, 128, {}), (cut, 128, {}), (cut, 128, dict(blend=False))]
        for mode in modes:
            for (fb, ff), t, kw in runs:
                cfg = dict(mode=mode, **kw)
                want = jbf.blockfps_frame(jsrc, jref, *s["jsups"], fb[0],
                                          ff[0], meta,
                                          jbf.BlockFPSConfig(**cfg), t)
                got = blockfps.blockfps_frame(tsrc, tref, *s["tsups"], fb[1],
                                              ff[1], tmeta,
                                              blockfps.BlockFPSConfig(**cfg),
                                              t)
                tfc.equal(got, want, f"{s['cfg']} {cfg} t{t}")
