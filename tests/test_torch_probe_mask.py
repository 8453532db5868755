"""PyTorch port: FieldProber's masked check, and the check of the tiled probe's
`active` mask that test_torch_probe_active_*.py run; split from
test_torch_probe.py (whose docstring says how the inputs are made) into a
file of at most six tests, which pytest-xdist's loadfile scheduling hands
out after the suite's longest file."""
import os
import sys

import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch.ops import probe as probe_ops
import torch_port_reference as tpr
from test_torch_probe import HEXAGON, _masked_probe_inputs  # noqa: E402


def check_active_mask(stats, pel, kk, handover):
    """With `active`, probe_sads_tiled (its plain version here; the kernel
    on the card) equals the unmasked output where active and is INVALID_SAD
    (in all three stats) elsewhere, through the tiled probe and through its
    hand-over to the per-block probe."""
    stack, cy, cx, src, offsets, bs, nbx, active = _masked_probe_inputs(
        stats, pel, kk, handover)
    wy_total, wx_total = probe_ops.tile_params(
        offsets, bs, bs, pel, 8 if kk <= 2 else 4, bs)[:2]
    assert (stack.shape[-1] < wx_total) == handover
    assert stack.shape[-2] >= wy_total
    args = (stack, cy, cx, src, offsets, bs, bs, pel)
    kw = dict(row_len=nbx, pitch_x=bs, stats=stats)
    full = probe_ops.probe_sads_tiled(*args, **kw)
    got = probe_ops.probe_sads_tiled(*args, **kw, active=active)
    keep = active if stats == "sad" else active[..., None]
    assert got.dtype == torch.int32 and got.shape == full.shape
    assert torch.equal(got, torch.where(keep, full,
                                        probe_ops.INVALID_SAD).to(torch.int32))
    assert 0 < int(active.sum()) < active.numel()
    assert bool((~active).flatten(2).all(dim=-1).any())    # dead rows
    sads = full if stats == "sad" else full[..., 0]
    assert bool((sads[active] != probe_ops.INVALID_SAD).any())
    if handover:
        assert not bool((sads == probe_ops.INVALID_SAD).any())
    else:
        assert bool((sads == probe_ops.INVALID_SAD).any())


@pytest.mark.parametrize("family,offsets,mask_of", [
    ("GRAY", tpr.WALK, tpr.entry_mask),     # the hexagon walk's 8 entries
    ("YUV420", HEXAGON, tpr.entry_mask),    # the chroma delta grid
    ("YUV420", ((1, -1),), tpr.block_mask), # one offset: chroma probed as is
], ids=["gray-walk", "yuv-hexagon", "yuv-one-offset"])
def test_field_prober_check_with_a_mask_keeps_the_state(family, offsets,
                                                        mask_of):
    """FieldProber.check hands its extra_mask to the probes, which then skip
    the masked entries; the state it returns is the one the unmasked probes
    give (_update costs every masked entry _INF)."""
    tpr.check_masked_state(family, 0, offsets, mask_of)

