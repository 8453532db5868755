"""PyTorch port: the other search options in one pyramid
(torch_port_reference.load_opts(): load()'s gray clip and jobs, pel 2, two
levels, UMH on level 0, NSTEP on level 1, trymany, the ring rescue badrange
-6 and divide 2) against the JAX package bit for bit: analyse_batch and
analyse()."""
import os
import sys

import pytest

import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mvtools_tpu_torch as port
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.core import config as pconfig
from mvtools_tpu_torch.core import types as ptypes
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr
from test_torch_pel4_slice import assert_field  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_opts(tmp_path_factory)


@pytest.fixture(scope="module")
def run():
    sspec, aspec = tpr.opts_configs(pconfig, ptypes)
    sups = build_super([torch.from_numpy(tpr.make_frames())], sspec)
    src, rf = tpr.job_indices()
    rescued = fe.rescued_blocks
    mv = port.analyse_batch(sups.map(lambda a: a[src]),
                            sups.map(lambda a: a[rf]), aspec)
    return dict(sspec=sspec, aspec=aspec, sups=sups, src=src, rf=rf, mv=mv,
                rescued=fe.rescued_blocks - rescued)


def test_opts_analyse_batch(ref, run):
    """Every level of every job, the divided level first (its meta the
    divided one); the ring rescue ran."""
    mv = run["mv"]
    assert mv.meta == run["aspec"].divided_meta
    assert len(mv.levels) == tpr.OPTS_LEVELS + 1
    assert_field(mv, ref, "mv_")
    assert run["rescued"] > 0


def test_opts_analyse_single_pair(ref, run):
    sups = run["sups"]
    one = port.analyse(sups.map(lambda a: a[run["src"][1]]),
                       sups.map(lambda a: a[run["rf"][1]]), run["aspec"],
                       engine="lockstep")
    assert_field(one, ref, "mv_", job=1)
