"""PyTorch port: pel 4 and the probe-only level search (bench.py config 2:
HEX2, searchparam 2, truemotion, the full pyramid) on the pel-4 reference
clip (torch_port_reference.load_pel4(): 512x96 gray, four jobs, a flashing
region so that the rescue runs at pel 4), against the JAX package bit for
bit: analyse_batch and analyse() on the port's own supers, Degrain1 of two
frames, and Recalculate at pel 4: HEX2 with divide 1 (the tiled probe), and
ONETIME, which takes the JAX package's per-block engine (exact SADs, every
block refined, a block under thsad keeping its predictor); the other
Recalculates are in test_torch_pel4_recalc.py. Level 0 is wider
than the tiled probe's window, so its walk goes through the tiled probe; the
coarser levels ride the dense map."""
import os
import sys

import numpy as np
import pytest

import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mvtools_tpu_torch as port
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.core import config as pconfig
from mvtools_tpu_torch.core import types as ptypes
from mvtools_tpu_torch.degrain import DegrainConfig, degrain
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr

SRC, REF = [1, 1, 2, 2], [2, 0, 3, 1]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_pel4(tmp_path_factory)


@pytest.fixture(scope="module")
def run(ref):
    """The port's supers of the reference clip and its analyse_batch over
    the four jobs, with the blocks its rescue took."""
    sspec, aspec = tpr.p4_configs(pconfig, ptypes)
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    rescued = fe.rescued_blocks
    mv = port.analyse_batch(sups.map(lambda a: a[SRC]),
                            sups.map(lambda a: a[REF]), aspec)
    return dict(sspec=sspec, aspec=aspec, sups=sups, mv=mv,
                rescued=fe.rescued_blocks - rescued)


def assert_field(mv, ref, prefix, job=None):
    assert len(mv.levels) == len([k for k in ref if k.startswith(
        prefix + "x")])
    for lv, level in enumerate(mv.levels):
        for k in ("x", "y", "sad"):
            want = ref[f"{prefix}{k}{lv}"]
            want = want if job is None else want[job]
            got = getattr(level, k).numpy()
            assert np.array_equal(got, want), (prefix, lv, k,
                                               int((got != want).sum()))


def test_pel4_super_and_analyse_batch(ref, run):
    """16 subplanes at level 0, equal to the JAX package's; every level of
    the four jobs' fields equal; the rescue ran at pel 4."""
    assert tuple(run["sups"].planes[0][0].shape[1:2]) == (16,)
    assert np.array_equal(run["sups"].planes[0][0].numpy(), ref["super0"])
    assert run["mv"].meta.pel == 4
    assert_field(run["mv"], ref, "mv_")
    assert run["rescued"] > 0


def test_pel4_analyse_single_pair(ref, run):
    """analyse() (one pair, no job axis) gives each job of the batch."""
    for j in (0, 3):
        one = port.analyse(run["sups"].map(lambda a: a[SRC[j]]),
                           run["sups"].map(lambda a: a[REF[j]]),
                           run["aspec"], engine="lockstep")
        assert one.levels[0].x.ndim == 2
        assert_field(one, ref, "mv_", job=j)


def test_pel4_degrain1(ref, run):
    """Degrain1 of frames 1 and 2 on the port's fields, fetching at pel 4."""
    sups, mv = run["sups"], run["mv"]
    for i, c in enumerate((1, 2)):
        mvs = [ptypes.MVField(tuple(ptypes.MVPlaneField(l.x[j], l.y[j],
                                                        l.sad[j])
                                    for l in mv.levels), mv.validity[j],
                              mv.meta) for j in (2 * i, 2 * i + 1)]
        out = degrain([torch.from_numpy(ref["frames"][c])],
                      [sups.map(lambda a: a[c + 1]),
                       sups.map(lambda a: a[c - 1])], mvs, mv.meta,
                      DegrainConfig(thsad=400))[0]
        assert np.array_equal(out.numpy(), ref["degrain"][i]), c


@pytest.mark.parametrize("name", ["hex2-div1", "onetime"])
def test_pel4_recalculate(ref, run, name):
    """Recalculate at pel 4 of the port's fields (with divide, the divided
    level first); test_torch_pel4_recalc.py holds the other P4_RECALC
    cases."""
    check_recalculate(ref, run, name)


def check_recalculate(ref, run, name):
    rcfg = port.RecalculateConfig(**tpr.recalc_kw(ptypes,
                                                  tpr.P4_RECALC[name]))
    rspec = rcfg.to_analyse_config().validate(run["sspec"])
    sups = run["sups"]
    got = port.recalculate(sups.map(lambda a: a[SRC]),
                           sups.map(lambda a: a[REF]), run["mv"], rspec,
                           rcfg)
    if rcfg.divide:
        assert got.meta == rspec.divided_meta
    assert_field(got, ref, f"rc_{name}_")
