"""Field-level lock-step motion search.

The whole plane of blocks — of every job of a batch — advances through
pseudo-EPZ together (PlaneOfBlocks.cpp:819-968 semantics, Jacobi predictors
instead of the reference's Gauss-Seidel raster).  Every field array carries
an explicit leading job axis: [J, nblk].  Every stage is one of:

* `DenseEvaluator.check_uniform` (analyse.py): a displacement every block
  shares (zero trial, the rescue cross/hex4 around (0,0)) costs one
  whole-plane shift + box sums.
* `MapProber.check`: per-block candidates looked up in the dense SAD map
  (ops/sadmap.py, one kernel pass per level).
* `FieldProber.check`: per-block candidates probed with the probe kernels
  (ops/probe.py: tiled, or per block on planes too small for a tile
  window) — the bad-SAD rescue, which walks far from the map anchor.

Data-dependent search trajectories (hex2's direction walk) become
field-level loops whose candidate sets are static supersets gated by
per-block masks; the loop condition is one host read per iteration
(counted in `host_syncs`).  Candidate EVALUATION ORDER within a batch
matches the reference's enumeration: the first candidate that reaches the
batch minimum wins, as the reference's strict `cost < mincost` update does.

Not bit-exact vs the reference's sequential engine by design: neighbour
predictors lag one Jacobi iteration and badcount feedback is per-block.
Ported: the plain-SAD cost (dct 0) and the SATD-mixed luma costs (dct
5-10, from the three-stat forms of the map and the probes), chroma and
overlapped block grids.  The DCT costs (dct 1-4) are not.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .core.types import SearchType
from .ops import probe as probe_ops
from .ops import sad as sad_ops
from .ops import sadmap
from .ops.pad import edge_pad

I32 = torch.int32
I64 = torch.int64
_INF = 1 << 62

host_syncs = 0   # scalar reads the host waited for (loop/branch conditions)


def any_true(mask: torch.Tensor) -> bool:
    """Host read of `mask.any()` — a real branch on device data."""
    global host_syncs
    host_syncs += 1
    return bool(mask.any().item())


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype, device) -> torch.Tensor:
    """Small constant tensor, made once per device."""
    return torch.tensor(values, dtype=dtype, device=device)


def _first_min(cost: torch.Tensor):
    """(min over the last axis, index of its FIRST occurrence).  Written
    without argmin, whose tie order is unspecified on CUDA."""
    m = cost.amin(dim=-1)
    d = cost.shape[-1]
    ar = torch.arange(d, device=cost.device)
    k = torch.where(cost == m[..., None], ar, d).amin(dim=-1)
    return m, k


def _pick(t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return t.gather(-1, k[..., None])[..., 0]


def _sat_add(a, b):
    """int64 sum of two int32 SAD tensors — int32 addition would wrap when
    both carry the tiled probe's INVALID_SAD sentinel."""
    return a.to(I64) + b.to(I64)


def mix_satd_cost(dctmode: int, s, satd_v, src_luma, ref_luma, dctweight16):
    """Luma cost for the SATD modes 5-10 from SAD, SATD and the two block
    sums (pobLumaSAD PlaneOfBlocks.cpp:117-203), int64.  All operands are
    non-negative, so the floor divisions are the reference's C divisions.
    src_luma, ref_luma and dctweight16 must broadcast against s."""
    s = s.to(I64)
    satd_v = satd_v.to(I64)
    if dctmode == 5:
        return satd_v
    if dctmode == 6:
        w16 = dctweight16.to(I64)
        mixed = (s * (16 - w16) + satd_v * w16) // 16
        return torch.where(w16 > 0, mixed, s)
    if dctmode in (7, 8):
        adapt = (src_luma - ref_luma).abs() > ((src_luma + ref_luma) >> 5)
        mixed = (s // 2 + satd_v // 2 if dctmode == 7
                 else s // 4 + satd_v // 2 + satd_v // 4)
        return torch.where(adapt, mixed, s)
    if dctmode == 9:
        w16 = dctweight16.to(I64)
        wh = w16 // 2
        mixed = (s * (16 - wh) + satd_v * wh) // 16
        return torch.where(w16 > 1, mixed, s)
    if dctmode == 10:
        adapt = (src_luma - ref_luma).abs() > ((src_luma + ref_luma) >> 4)
        mixed = s // 2 + satd_v // 4 + s // 4
        return torch.where(adapt, mixed, s)
    raise ValueError(f"dctmode {dctmode}")


def satd_cost(dctmode: int, src_luma_blocks, dctweight16) -> dict:
    """The cost keywords (dctmode, src_luma, dctweight16) that FieldProber,
    MapProber and DenseEvaluator take, from the luma source blocks
    [J, nblk, bs_y, bs_x] and the per-job weight [J].  src_luma holds the
    source blocks' sums for the adaptive modes 7, 8 and 10, which compare
    them with the reference's; the other modes never read them."""
    if dctmode in (7, 8, 10):
        src_luma = sad_ops.luma(src_luma_blocks).to(I64)
    elif dctmode:
        src_luma = torch.zeros(src_luma_blocks.shape[:2], dtype=I64,
                               device=src_luma_blocks.device)
    else:
        src_luma = None
    return dict(dctmode=dctmode, src_luma=src_luma, dctweight16=dctweight16)


def _offset_tensors(offsets, device):
    return (_const(tuple(int(o[0]) for o in offsets), I32, device),
            _const(tuple(int(o[1]) for o in offsets), I32, device))


class FieldProber:
    """Per-block probe evaluation through the probe kernels.

    Holds the padded subplane stacks and per-block static context of one
    pyramid level.  All check* methods take and return a field state dict
    of [J, nblk] tensors (bx, by, bsad, mincost, dir).
    """

    PAD = 16  # full-pel window padding beyond the frame's own padding

    def __init__(self, ctx, src_blocks, x0_a, y0_a, xc_a, yc_a, bounds, pnew,
                 stacks=None, dctmode: int = 0, src_luma=None,
                 dctweight16=None):
        """src_blocks: per color plane [J, nblk, bs_y, bs_x] uint8 (luma, or
        luma, U, V with ctx.chroma); stacks: the padded stacks of
        pad_stacks(ctx), made here when not given.  dctmode 5-10 makes the
        luma cost the SATD mix of src_luma [J, nblk] int64 (the source
        blocks' sums) and dctweight16 [J]; chroma stays plain SAD."""
        self.dctmode = dctmode
        self.src_luma = src_luma
        self.dctweight16 = dctweight16
        self.ctx = ctx
        self.pel = ctx.pel
        self.logp = ctx.log_pel
        self.bs = ctx.blk_size
        self.bsc = ctx.blk_size_c
        self.chroma = ctx.chroma
        self.bounds = bounds
        self.pnew = pnew
        self.src_blocks = src_blocks[0]
        if stacks is None:
            stacks = pad_stacks(ctx)
        self.stack = stacks[0]
        # block origin in padded pel coordinates, [nblk]
        self.base_y = (y0_a + self.PAD) << self.logp
        self.base_x = (x0_a + self.PAD) << self.logp
        self.nbx = ctx.nblk[0]
        self.pitch_x = ctx.blk_size[0] - ctx.overlap[0]
        logx, logy = ctx.log_ratio_uv
        self.pitch_xc = max(1, self.pitch_x >> logx)
        if ctx.chroma:
            self.padc = chroma_pad(ctx)
            self.stack_u, self.stack_v = stacks[1], stacks[2]
            self.src_u_blocks, self.src_v_blocks = src_blocks[1:3]
            self.cbase_y = (yc_a + self.padc) << self.logp
            self.cbase_x = (xc_a + self.padc) << self.logp

    # -- raw SAD evaluation -------------------------------------------------

    def _probe(self, stack, cy, cx, src, offsets, bs_y, bs_x, pitch,
               stats="sad"):
        """[J, nblk, K, D] int32 through the tiled probe ([..., 3] stat
        triples with stats="sad_satd_luma"); a candidate outside its
        tile's window reports INVALID_SAD and loses every cost comparison
        (the dense zero trial guarantees a real bound).  A plane too small
        for the tile window takes the per-block probe instead."""
        return probe_ops.probe_sads_tiled(
            stack, cy.contiguous(), cx.contiguous(), src, offsets, bs_y,
            bs_x, self.pel, row_len=self.nbx, pitch_x=pitch, stats=stats)

    def _mix(self, stats3):
        """[J, nblk, ..., 3] (SAD, SATD, reference sum) -> the mixed luma
        cost of this prober's dctmode, int64 (pobLumaSAD)."""
        extra = (1,) * (stats3.ndim - 3)
        return mix_satd_cost(
            self.dctmode, stats3[..., 0], stats3[..., 1],
            self.src_luma.reshape(self.src_luma.shape + extra),
            stats3[..., 2].to(I64),
            self.dctweight16.reshape((-1, 1) + extra))

    def _luma_probe(self, cy, cx, offsets):
        """[J, nblk, K, D] int64 luma costs at padded pel positions: plain
        SAD, or the SATD mix for dct 5-10."""
        if self.dctmode:
            return self._mix(self._probe(
                self.stack, cy, cx, self.src_blocks, offsets, self.bs[1],
                self.bs[0], self.pitch_x, stats="sad_satd_luma"))
        return self._probe(self.stack, cy, cx, self.src_blocks, offsets,
                           self.bs[1], self.bs[0], self.pitch_x).to(I64)

    def _cpos(self, v, log_ratio: int):
        """Chroma coordinate of a luma pel vector: division by the
        subsampling ratio that truncates toward zero (the negative-bias
        rounding of pobGetRefBlockU/V, PlaneOfBlocks.cpp:57-77)."""
        return (v + (v < 0).to(I32) * ((1 << log_ratio) - 1)) >> log_ratio

    def luma_sads(self, vx, vy, offsets=((0, 0),)):
        """[J, nblk, D] int64 luma costs at per-block candidates (vx, vy) +
        static pel offsets (plain SAD, or the SATD mix for dct 5-10)."""
        cy = (self.base_y + vy)[..., None]
        cx = (self.base_x + vx)[..., None]
        return self._luma_probe(cy, cx, offsets)[:, :, 0, :]

    def _chroma_probe(self, cy, cx, offsets):
        """U + V SADs [J, nblk, K, D] int64 at chroma pel positions."""
        su = self._probe(self.stack_u, cy, cx, self.src_u_blocks, offsets,
                         self.bsc[1], self.bsc[0], self.pitch_xc)
        sv = self._probe(self.stack_v, cy, cx, self.src_v_blocks, offsets,
                         self.bsc[1], self.bsc[0], self.pitch_xc)
        return _sat_add(su, sv)

    def chroma_sads(self, vx, vy, offsets=((0, 0),)):
        """[J, nblk, D] int64 chroma SADs (U + V) at the chroma positions
        of the luma candidates.

        Multi-offset sets share ONE probe per plane: the chroma displacement
        of a luma offset is one of a small static delta grid (the truncating
        division can land on either of two chroma-pel cells depending on the
        candidate's parity and sign), so the whole grid is probed around the
        candidate's own chroma position and the exact column is selected per
        (block, offset) afterwards."""
        if not self.chroma:
            return torch.zeros(vx.shape + (len(offsets),), dtype=I64,
                               device=vx.device)
        logx, logy = self.ctx.log_ratio_uv
        rx, ry = (1 << logx) - 1, (1 << logy) - 1
        if len(offsets) == 1:
            dx, dy = offsets[0]
            cx = self.cbase_x + self._cpos(vx + dx, logx)
            cy = self.cbase_y + self._cpos(vy + dy, logy)
            return self._chroma_probe(cy[..., None], cx[..., None],
                                      ((0, 0),))[:, :, :, 0]
        xs = [o[0] for o in offsets]
        ys = [o[1] for o in offsets]
        gx0, gx1 = (min(xs) - rx) >> logx, ((max(xs) + rx) >> logx) + 1
        gy0, gy1 = (min(ys) - ry) >> logy, ((max(ys) + ry) >> logy) + 1
        grid = tuple((ddx, ddy) for ddy in range(gy0, gy1)
                     for ddx in range(gx0, gx1))
        base_dx = self._cpos(vx, logx)
        base_dy = self._cpos(vy, logy)
        tot = self._chroma_probe((self.cbase_y + base_dy)[..., None],
                                 (self.cbase_x + base_dx)[..., None],
                                 grid)[:, :, 0, :]          # [J, nblk, |grid|]
        ox, oy = _offset_tensors(offsets, vx.device)
        ddx = self._cpos(vx[..., None] + ox, logx) - base_dx[..., None] - gx0
        ddy = self._cpos(vy[..., None] + oy, logy) - base_dy[..., None] - gy0
        ngx, ngy = gx1 - gx0, gy1 - gy0
        ok = (ddx >= 0) & (ddx < ngx) & (ddy >= 0) & (ddy < ngy)
        gi = (ddy.clamp(0, ngy - 1) * ngx + ddx.clamp(0, ngx - 1)).to(I64)
        return torch.where(ok, tot.gather(-1, gi), 0)

    # -- check primitives ---------------------------------------------------

    def check(self, st, cand_x, cand_y, offsets=((0, 0),),
              penalty_new=True, update_xy=True, dir_vals=None,
              extra_mask=None, lam=None, pred=None):
        """Evaluate per-block candidates x static offsets, enumerated
        offset-major in order; the first candidate reaching the minimum
        wins if it improves on st["mincost"] (pobCheckMV
        PlaneOfBlocks.cpp:219-261)."""
        dxmin, dxmax, dymin, dymax = self.bounds
        offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
        cvx = torch.minimum(torch.maximum(cand_x, dxmin), dxmax - 1)
        cvy = torch.minimum(torch.maximum(cand_y, dymin), dymax - 1)
        ls = self.luma_sads(cvx, cvy, offsets)          # [J, nblk, D]
        cs = self.chroma_sads(cvx, cvy, offsets) if self.chroma else None
        ox, oy = _offset_tensors(offsets, cand_x.device)
        vx = cand_x[..., None] + ox
        vy = cand_y[..., None] + oy
        return _update(self, st, ls, cs, vx, vy, lam, pred,
                       dir_vals=dir_vals, mask=extra_mask,
                       update_xy=update_xy, penalty_new=penalty_new)

    def plain_sad(self, vx, vy):
        """[J, nblk] unmasked luma + chroma cost at clamped per-block
        candidates (a predictor trial clamps beforehand and skips the
        bounds check)."""
        out = self.luma_sads(vx, vy)[..., 0]
        if self.chroma:
            out = out + self.chroma_sads(vx, vy)[..., 0]
        return out

    def plain_sads_multi(self, vxs, vys):
        """[J, nblk, K] unmasked luma + chroma costs at K clamped candidates
        per block — one probe per plane for all K (the predictor trials
        batched)."""
        vx = torch.stack(vxs, dim=-1)
        vy = torch.stack(vys, dim=-1)
        ls = self._luma_probe(self.base_y[:, None] + vy,
                              self.base_x[:, None] + vx, ((0, 0),))[..., 0]
        if not self.chroma:
            return ls
        logx, logy = self.ctx.log_ratio_uv
        cs = self._chroma_probe(
            self.cbase_y[:, None] + self._cpos(vy, logy),
            self.cbase_x[:, None] + self._cpos(vx, logx), ((0, 0),))[..., 0]
        return ls + cs


def chroma_pad(ctx) -> int:
    """Probe padding of the chroma stacks."""
    logx, logy = ctx.log_ratio_uv
    return max(FieldProber.PAD >> logx, FieldProber.PAD >> logy, 4)


def pad_stacks(ctx):
    """The probe-padded reference stacks of a level: (luma,) or
    (luma, U, V)."""
    out = [probe_ops.pad_stack(ctx.ref_stacks[0], FieldProber.PAD)]
    if ctx.chroma:
        padc = chroma_pad(ctx)
        out += [probe_ops.pad_stack(ctx.ref_stacks[1], padc),
                probe_ops.pad_stack(ctx.ref_stacks[2], padc)]
    return tuple(out)


def _update(p, st, ls, cs, vx, vy, lam, pred, dir_vals=None, mask=None,
            update_xy=True, penalty_new=True):
    """Running-minimum update from luma / chroma SAD columns ls, cs
    [J, nblk, D] (cs None: no chroma term) at vectors vx/vy [J, nblk, D]
    already in evaluation order."""
    dxmin, dxmax, dymin, dymax = (b[:, None] for b in p.bounds)
    ok = (vx >= dxmin) & (vy >= dymin) & (vx < dxmax) & (vy < dymax)
    if mask is not None:
        ok = ok & mask
    # a probed SAD used clamped coords; exact only when valid
    pdx = pred[0][..., None] - torch.minimum(torch.maximum(vx, dxmin),
                                             dxmax - 1)
    pdy = pred[1][..., None] - torch.minimum(torch.maximum(vy, dymin),
                                             dymax - 1)
    dist = (pdx * pdx + pdy * pdy).to(I32)
    sad_tot = ls if cs is None else ls + cs
    # lambda * dist >> 8 truncated through C int on purpose
    cost = ((lam[..., None] * dist.to(I64)) >> 8).to(I32).to(I64) + sad_tot
    if penalty_new:
        cost = cost + ((p.pnew * ls) >> 8)
        if cs is not None:
            cost = cost + ((p.pnew * cs) >> 8)
    cost = torch.where(ok, cost, _INF)
    best, k = _first_min(cost)
    improve = best < st["mincost"]
    st = dict(st)
    if update_xy:
        st["bx"] = torch.where(improve, _pick(vx, k), st["bx"])
        st["by"] = torch.where(improve, _pick(vy, k), st["by"])
    st["bsad"] = torch.where(improve, _pick(sad_tot, k), st["bsad"])
    st["mincost"] = torch.where(improve, best, st["mincost"])
    if dir_vals is not None:
        dv = _const(tuple(int(v) for v in dir_vals), I32, k.device)
        st["dir"] = torch.where(improve, dv[k], st["dir"])
    return st


def _map_tile(ctx) -> int:
    """Blocks per map tile: the blocks whose source span fits 256 pixels
    (2..32).  Part of the result: the anchor is per tile."""
    bsx = ctx.blk_size[0]
    pitch = bsx - ctx.overlap[0]
    t = max(2, min(32, (256 - bsx) // max(1, pitch) + 1))
    return min(t, ctx.nblk[0])


def map_radius(ctx) -> int:
    """Pel-grid radius of the map: walk drift (hex2 range + ring) plus
    the anchor's alignment rounding loss (with chroma the anchor is aligned
    to a full chroma pel)."""
    logx, logy = ctx.log_ratio_uv
    align = 1 << (ctx.log_pel + (max(logx, logy) if ctx.chroma else 0))
    return 6 + align // 2


def _chroma_map_geom(ctx, r: int):
    """(rc_y, rc_x, pitch_xc, pitch_yc) of the chroma maps that go with a
    luma map of radius r."""
    logx, logy = ctx.log_ratio_uv
    return ((r >> logy) + 1, (r >> logx) + 1,
            (ctx.blk_size[0] - ctx.overlap[0]) >> logx,
            (ctx.blk_size[1] - ctx.overlap[1]) >> logy)


def map_supported(ctx, r: int, dctmode: int = 0) -> bool:
    """Static predicate: MapProber usable on this level's geometry (8-bit,
    pel <= 2, windows fit the padded stacks, chroma pitch integral; the
    SATD modes 5-10 additionally need the stat map's alignment: pitch and
    block width multiples of 8, block height of 4).  dct 1-4 is not
    ported."""
    bsx, bsy = ctx.blk_size
    if dctmode and not 5 <= dctmode <= 10:
        return False
    if ctx.bits != 8 or ctx.pel > 2:
        return False
    pitch = bsx - ctx.overlap[0]
    if dctmode and (pitch % 8 or bsx % 8 or bsy % 4
                    or not sad_ops.satd_supported(bsx, bsy)):
        return False
    tile = _map_tile(ctx)
    hp = ctx.padded[1] + 2 * FieldProber.PAD + probe_ops.ALIGN_SLACK_Y
    wp = ctx.padded[0] + 2 * FieldProber.PAD + probe_ops.ALIGN_SLACK_X
    (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
        r, r, bsy, bsx, ctx.pel, tile, pitch, hp, wp)
    if hi_y < lo_y or hi_x < lo_x:
        return False
    if ctx.chroma:
        logx, logy = ctx.log_ratio_uv
        if pitch % (1 << logx) != 0:
            return False
        bcx, bcy = ctx.blk_size_c
        rc_y, rc_x, pit_c, _ = _chroma_map_geom(ctx, r)
        padc = chroma_pad(ctx)
        hp_c = (ctx.padded[1] >> logy) + 2 * padc + probe_ops.ALIGN_SLACK_Y
        wp_c = (ctx.padded[0] >> logx) + 2 * padc + probe_ops.ALIGN_SLACK_X
        (lo, hi), (lo2, hi2) = sadmap.anchor_bounds(
            rc_y, rc_x, bcy, bcx, ctx.pel, tile, pit_c, hp_c, wp_c)
        if hi < lo or hi2 < lo2:
            return False
    return True


def _med3_tiles(a, nby, ntx, tile):
    """[J, nby*ntx*tile] (row-padded) -> per-tile med3 of the first,
    middle and last entry, [J, nby, ntx]."""
    t = a.reshape(-1, nby, ntx, tile)
    return probe_ops._med3(t[..., 0], t[..., tile // 2], t[..., tile - 1])


def _row_pad(a, nby, nbx, rlp):
    """Edge-pad each block row of a [J, nby*nbx] tensor to rlp."""
    t = a.reshape(-1, nby, nbx)
    if rlp != nbx:
        t = edge_pad(t, 0, 0, 0, rlp - nbx)
    return t.reshape(-1, nby * rlp)


class MapProber(FieldProber):
    """FieldProber whose SAD source is a dense per-block offset map
    (ops/sadmap.py) instead of per-candidate window probes.

    One SAD-map kernel pass per plane per level evaluates the whole +-R pel
    grid around a per-tile predictor anchor; every check() thereafter —
    predictor trials, the hex2 walk, expanding rings — is a gather from
    the maps.  Candidates outside the grid report INVALID_SAD and lose (the
    dense zero trial bounds every block); the bad-SAD rescue keeps using a
    probe-based prober via field_epz's probe_p argument."""

    def __init__(self, ctx, src_blocks, x0_a, y0_a, xc_a, yc_a, bounds, pnew,
                 pred_vx, pred_vy, r: int = 0, stacks=None, dctmode: int = 0,
                 src_luma=None, dctweight16=None):
        super().__init__(ctx, src_blocks, x0_a, y0_a, xc_a, yc_a, bounds,
                         pnew, stacks=stacks, dctmode=dctmode,
                         src_luma=src_luma, dctweight16=dctweight16)
        # dct 5-10: the luma map holds (SAD, SATD, reference sum) triples
        # and the mix runs on each looked-up triple; chroma maps stay SAD
        self._stats = "sad_satd_luma" if dctmode else "sad"
        if not r:
            r = map_radius(ctx)
        self.r = r
        logp = self.logp
        pel = self.pel
        logx, logy = ctx.log_ratio_uv
        bsx, bsy = ctx.blk_size
        nbx, nby = ctx.nblk
        pitch = self.pitch_x
        pitch_y = bsy - ctx.overlap[1]
        tile = _map_tile(ctx)
        rlp = -(-nbx // tile) * tile
        ntx = rlp // tile
        hpad, hpad_c = ctx.hpad
        vpad, vpad_c = ctx.vpad
        PAD = self.PAD
        dev = pred_vx.device

        # ---- anchors: per-tile med3 of the predictor field, aligned so
        # that every derived plane anchor is full-pel, clamped so the
        # nominal window fits the padded stack
        pvx = _row_pad(pred_vx.to(I32), nby, nbx, rlp)
        pvy = _row_pad(pred_vy.to(I32), nby, nbx, rlp)
        med_x = _med3_tiles(pvx, nby, ntx, tile)       # [J, nby, ntx]
        med_y = _med3_tiles(pvy, nby, ntx, tile)
        sh_x = logp + (logx if ctx.chroma else 0)
        sh_y = logp + (logy if ctx.chroma else 0)
        # static block-0 source origins per tile column / block row and
        # their probe-padded stack-coordinate counterparts
        tcol = np.arange(ntx, dtype=np.int64)
        brow = np.arange(nby, dtype=np.int64)
        c_x = hpad + pitch * tile * tcol + PAD
        c_y = vpad + pitch_y * brow + PAD
        hp, wp = self.stack.shape[-2], self.stack.shape[-1]
        (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
            r, r, bsy, bsx, pel, tile, pitch, hp, wp)

        def clamp_align(av, c, lo, hi, sh):
            """Clamp the pel-units anchor so fp = c + (av >> logp) lands
            in [lo, hi], stepping only in 2^sh units."""
            s = 1 << sh
            lo_v = -(-((lo - c) << logp) // s) * s          # ceil-align
            hi_v = (((hi - c) << logp) // s) * s            # floor-align
            lo_t = torch.as_tensor(lo_v, dtype=I32, device=dev)
            hi_t = torch.as_tensor(hi_v, dtype=I32, device=dev)
            return torch.minimum(torch.maximum(av, lo_t), hi_t)

        def full_pel(av, c, axis):
            """[J, nby*ntx] full-pel stack positions c + (av >> logp)."""
            c_t = torch.as_tensor(c, dtype=I32, device=dev)
            c_t = c_t[None, None, :] if axis == "x" else c_t[None, :, None]
            return (c_t + (av >> logp)).reshape(-1, nby * ntx).contiguous()

        def per_block(a_tile):
            t = a_tile.repeat_interleave(tile, dim=2)
            return t[:, :, :nbx].reshape(-1, nby * nbx)

        av_x = clamp_align((med_x >> sh_x) << sh_x, c_x[None, :], lo_x, hi_x,
                           sh_x)
        av_y = clamp_align((med_y >> sh_y) << sh_y, c_y[:, None], lo_y, hi_y,
                           sh_y)
        self._av_x = per_block(av_x)                       # [J, nblk] pel
        self._av_y = per_block(av_y)
        self._m_l = sadmap.sad_map(
            self.stack, ctx.src_planes[0], full_pel(av_y, c_y, "y"),
            full_pel(av_x, c_x, "x"), r, r, bsy, bsx, pel, tile, pitch,
            pitch_y, nbx, nby, vpad, hpad, stats=self._stats)
        if ctx.chroma:
            bcx, bcy = ctx.blk_size_c
            self._rc_y, self._rc_x, pit_c, pit_cy = _chroma_map_geom(ctx, r)
            padc = self.padc
            cc_x = hpad_c + pit_c * tile * tcol + padc
            cc_y = vpad_c + pit_cy * brow + padc
            hp_c, wp_c = self.stack_u.shape[-2:]
            (lo_cy, hi_cy), (lo_cx, hi_cx) = sadmap.anchor_bounds(
                self._rc_y, self._rc_x, bcy, bcx, pel, tile, pit_c, hp_c,
                wp_c)
            # derived chroma anchors stay full-pel (av is a multiple of
            # 2^sh); the chroma clamp steps in pel units only
            avc_x = clamp_align(av_x >> logx, cc_x[None, :], lo_cx, hi_cx,
                                logp)
            avc_y = clamp_align(av_y >> logy, cc_y[:, None], lo_cy, hi_cy,
                                logp)
            self._avc_x = per_block(avc_x)
            self._avc_y = per_block(avc_y)
            afc_y = full_pel(avc_y, cc_y, "y")
            afc_x = full_pel(avc_x, cc_x, "x")
            maps = [sadmap.sad_map(
                stack, plane, afc_y, afc_x, self._rc_y, self._rc_x, bcy, bcx,
                pel, tile, pit_c, pit_cy, nbx, nby, vpad_c, hpad_c)
                for stack, plane in ((self.stack_u, ctx.src_planes[1]),
                                     (self.stack_v, ctx.src_planes[2]))]
            self._m_c = maps[0].add_(maps[1])

    @staticmethod
    def _lookup(m, iy, ix):
        """int64 values of map m [J, nblk, Dy, Dx] at per-block grid
        indices iy/ix [J, nblk, D]; INVALID_SAD outside the grid."""
        dy_n, dx_n = m.shape[-2:]
        ok = (iy >= 0) & (iy < dy_n) & (ix >= 0) & (ix < dx_n)
        flat = (iy.clamp(0, dy_n - 1) * dx_n
                + ix.clamp(0, dx_n - 1)).to(I64)
        v = m.reshape(m.shape[0], m.shape[1], -1).gather(-1, flat)
        return torch.where(ok, v, probe_ops.INVALID_SAD).to(I64)

    @staticmethod
    def _lookup3(m, iy, ix):
        """(stat triples [J, nblk, D, 3] int32, validity [J, nblk, D]) of
        map m [J, nblk, Dy, Dx, 3] at per-block grid indices iy/ix
        [J, nblk, D]."""
        dy_n, dx_n = m.shape[2:4]
        ok = (iy >= 0) & (iy < dy_n) & (ix >= 0) & (ix < dx_n)
        flat = (iy.clamp(0, dy_n - 1) * dx_n
                + ix.clamp(0, dx_n - 1)).to(I64)
        v = m.reshape(m.shape[0], m.shape[1], -1, 3).gather(
            2, flat[..., None].expand(-1, -1, -1, 3))
        return v, ok

    def _luma_at(self, vx, vy):
        """Luma map costs at pel vectors vx/vy [J, nblk, D]: validity comes
        from the grid index, the SATD mix (dct 5-10) runs on the looked-up
        triple, and INVALID_SAD is written over it outside the grid."""
        iy = vy - self._av_y[..., None] + self.r
        ix = vx - self._av_x[..., None] + self.r
        if self._stats == "sad":
            return self._lookup(self._m_l, iy, ix)
        v3, ok = self._lookup3(self._m_l, iy, ix)
        return torch.where(ok, self._mix(v3), probe_ops.INVALID_SAD)

    def _chroma_at(self, vx, vy):
        """U + V map values at the chroma positions of luma pel vectors
        vx/vy [J, nblk, D]."""
        logx, logy = self.ctx.log_ratio_uv
        return self._lookup(
            self._m_c,
            self._cpos(vy, logy) - self._avc_y[..., None] + self._rc_y,
            self._cpos(vx, logx) - self._avc_x[..., None] + self._rc_x)

    def luma_sads(self, vx, vy, offsets=((0, 0),)):
        """[J, nblk, D] int64 map values at (vx + dx, vy + dy);
        INVALID_SAD outside the grid."""
        ox, oy = _offset_tensors(offsets, vx.device)
        return self._luma_at(vx[..., None] + ox, vy[..., None] + oy)

    def chroma_sads(self, vx, vy, offsets=((0, 0),)):
        if not self.chroma:
            return torch.zeros(vx.shape + (len(offsets),), dtype=I64,
                               device=vx.device)
        ox, oy = _offset_tensors(offsets, vx.device)
        return self._chroma_at(vx[..., None] + ox, vy[..., None] + oy)

    def plain_sads_multi(self, vxs, vys):
        """[J, nblk, K] unmasked luma + chroma SADs at K clamped candidates
        per block (the predictor trials batched)."""
        vx = torch.stack(vxs, dim=-1)
        vy = torch.stack(vys, dim=-1)
        out = self._luma_at(vx, vy)
        if self.chroma:
            out = out + self._chroma_at(vx, vy)
        return out


def _ring_offsets(r, s):
    offs = []
    for i in range(-r + s, r, s):
        offs += [(i, -r), (i, r)]
    for j in range(-r + s, r, s):
        offs += [(-r, j), (r, j)]
    offs += [(-r, -r), (-r, r), (r, -r), (r, r)]
    return offs


def _expanding(p: FieldProber, st, r, s, cx, cy, lam, pred, active=None):
    offs = _ring_offsets(r, s)
    em = None if active is None else active[..., None]
    return p.check(st, cx, cy, offs, lam=lam, pred=pred, extra_mask=em)


def _exhaustive(p, st, radius, lam, pred, active=None):
    offs = []
    for r in range(1, radius + 1):
        offs += _ring_offsets(r, 1)
    em = None if active is None else active[..., None]
    return p.check(st, st["bx"], st["by"], offs, lam=lam, pred=pred,
                   extra_mask=em)


_HEXP = [(-1, -2), (-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2),
         (-1, -2), (-2, 0)]
_MOD6M1 = [5, 0, 1, 2, 3, 4, 5, 0]


def _table(tbl, idx):
    """tbl[idx] for a small static table; result shape idx.shape +
    tbl.shape[1:]."""
    t = np.asarray(tbl)
    dtype = torch.bool if t.dtype == bool else I32
    flat = _const(tuple(t.reshape(-1).tolist()), dtype, idx.device)
    return flat.reshape(t.shape)[idx.to(I64)]


def _hex2_general(p: FieldProber, st, i_me_range, lam, pred, active=None):
    """pobHex2Search (PlaneOfBlocks.cpp:661-724) at field level: the
    direction walk probes the full 8-entry hexagon window with a
    direction-dependent per-block mask."""
    hx = [h[0] for h in _HEXP]
    hy = [h[1] for h in _HEXP]
    bmx, bmy = st["bx"], st["by"]

    def act(mask):
        return mask if active is None else (mask & active)

    if i_me_range > 1:
        st = dict(st, dir=torch.full_like(st["dir"], -2))
        offs = [(-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2)]
        em = act(torch.ones_like(bmx, dtype=torch.bool))[..., None]
        st = p.check(st, bmx, bmy, offs, update_xy=False,
                     dir_vals=[0, 1, 2, 3, 4, 5], extra_mask=em,
                     lam=lam, pred=pred)

        walked = st["dir"] != -2
        d0 = st["dir"].clamp(-1, 6)
        bmx = torch.where(walked, bmx + _table(hx, d0 + 1), bmx)
        bmy = torch.where(walked, bmy + _table(hy, d0 + 1), bmy)

        dxmin, dxmax, dymin, dymax = p.bounds

        def in_bounds(x, y):
            return (x >= dxmin) & (y >= dymin) & (x < dxmax) & (y < dymax)

        # candidate superset = the 8 hexp entries; per block, entries
        # odir, odir+1, odir+2 are live, in that order (the reference
        # checks them in exactly this order)
        live_table = np.zeros((6, 8), bool)
        for odir in range(6):
            live_table[odir, odir:odir + 3] = True

        walking = walked
        i = 1
        while i < i_me_range // 2 and any_true(walking):
            walking = walking & in_bounds(bmx, bmy) & (st["dir"] != -2)
            odir = _table(_MOD6M1, st["dir"].clamp(-1, 6) + 1)
            st2 = dict(st, dir=torch.full_like(st["dir"], -2))
            mask = _table(live_table, odir) & act(walking)[..., None]
            # dir value for entry e is e-1 (odir-1, odir, odir+1 for
            # entries odir..odir+2)
            st2 = p.check(st2, bmx, bmy, _HEXP, update_xy=False,
                          dir_vals=[e - 1 for e in range(8)],
                          extra_mask=mask, lam=lam, pred=pred)
            moved = st2["dir"] != -2
            d = st2["dir"].clamp(-1, 6)
            step = moved & walking
            bmx = torch.where(step, bmx + _table(hx, d + 1), bmx)
            bmy = torch.where(step, bmy + _table(hy, d + 1), bmy)
            st = {k: torch.where(walking, st2[k], st[k]) for k in st}
            walking = step
            i += 1
        st = dict(st, bx=bmx, by=bmy)

    return _expanding(p, st, 1, 1, st["bx"], st["by"], lam, pred,
                      active=active)


def refine(p: FieldProber, st, search: SearchType, param: int, lam, pred,
           active=None):
    """pobRefine (PlaneOfBlocks.cpp:772-816), field level; HEX2 and
    EXHAUSTIVE are ported (with the plain-SAD cost and the SATD costs of
    dct 5-10, whichever the prober carries)."""
    if search == SearchType.EXHAUSTIVE:
        return _exhaustive(p, st, param, lam, pred, active=active)
    if search == SearchType.HEX2:
        return _hex2_general(p, st, param, lam, pred, active=active)
    raise NotImplementedError(
        f"search={SearchType(search).name} is not ported: HEX2 and "
        "EXHAUSTIVE are (UMH, ONETIME, NSTEP, LOGARITHMIC, HORIZONTAL and "
        "VERTICAL are not)")


def field_epz(p: FieldProber, dense, level_params, gx, gy, pred_main, preds,
              lam, idx, do_rescue: bool = True,
              probe_p: Optional[FieldProber] = None):
    """Whole-plane pseudo-EPZ for one Jacobi iteration
    (pobPseudoEPZSearch PlaneOfBlocks.cpp:819-968, dct 0 and 5-10, no
    trymany).

    pred_main: (x, y, sad) main predictor tensors [J, nblk]; preds: list of
    4 (x, y) predictor pairs; gx/gy: [J] global vector; lam: adapted lambda
    per block.  Returns the field state dict.  probe_p serves the bad-SAD
    rescue: the rescue walks far from the map anchor, so it needs a
    window-probing prober.
    """
    search = level_params["search"]
    param = level_params["param"]
    pzero = level_params["pzero"]
    pglobal = level_params["pglobal"]
    if level_params["trymany"]:
        raise NotImplementedError("trymany=True is not ported")
    dxmin, dxmax, dymin, dymax = p.bounds
    prx, pry, prs = pred_main
    pred = (prx, pry)

    # ---- zero trial (dense; no bounds check) ------------------------------
    sad0 = dense.luma_sads(0, 0) + dense.chroma_sads(0, 0)
    st = dict(bx=torch.zeros_like(prx), by=torch.zeros_like(pry),
              bsad=sad0, mincost=sad0 + ((pzero * sad0) >> 8),
              dir=torch.zeros_like(prx))

    gxc = torch.minimum(torch.maximum(gx[:, None], dxmin), dxmax - 1)
    gyc = torch.minimum(torch.maximum(gy[:, None], dymin), dymax - 1)

    # ---- global + main + 4 neighbour predictors, one lookup ---------------
    qs = [(torch.minimum(torch.maximum(q[0], dxmin), dxmax - 1),
           torch.minimum(torch.maximum(q[1], dymin), dymax - 1))
          for q in preds]
    sads = p.plain_sads_multi(
        [gxc, prx] + [q[0] for q in qs],
        [gyc, pry] + [q[1] for q in qs])          # [J, nblk, 6]
    # global: cost = sad + pglobal penalty, unconditional bounds-free
    sad_g = sads[..., 0]
    cost_g = sad_g + ((pglobal * sad_g) >> 8)
    take = cost_g < st["mincost"]
    st = dict(st,
              bx=torch.where(take, gxc, st["bx"]),
              by=torch.where(take, gyc, st["by"]),
              bsad=torch.where(take, sad_g, st["bsad"]),
              mincost=torch.where(take, cost_g, st["mincost"]))
    # main predictor: cost = plain sad
    sad_p = sads[..., 1]
    take = sad_p < st["mincost"]
    st = dict(st,
              bx=torch.where(take, prx, st["bx"]),
              by=torch.where(take, pry, st["by"]),
              bsad=torch.where(take, sad_p, st["bsad"]),
              mincost=torch.where(take, sad_p, st["mincost"]))
    # neighbours: bounds mask + MD cost, no penaltyNew (the SAD was looked
    # up at the clamped position, exact whenever valid)
    st = _update(p, st, sads[..., 2:], None,
                 torch.stack([q[0] for q in preds], dim=-1),
                 torch.stack([q[1] for q in preds], dim=-1),
                 lam, pred, penalty_new=False)
    st = refine(p, st, search, param, lam, pred)

    # ---- bad-SAD rescue (PlaneOfBlocks.cpp:938-963) ------------------------
    if not do_rescue:
        return st
    return field_rescue(p, dense, level_params, st, lam, pred, idx,
                        probe_p if probe_p is not None else p)


def field_rescue(p: FieldProber, dense, level_params, st, lam, pred,
                 idx, probe_p: Optional[FieldProber] = None):
    """The bad-SAD rescue tail of field_epz (PlaneOfBlocks.cpp:938-963).
    It runs for the whole batch behind one host read of `any(bad)`; every
    step is gated per block by `bad`, so blocks (and whole jobs) with no
    bad SAD come out unchanged."""
    if probe_p is None:
        probe_p = p
    badsad = level_params["badsad"]
    badrange = level_params["badrange"]
    found_sad = st["bsad"]
    bad = (idx > 1) & (found_sad > badsad)
    pelf = p.pel
    if not any_true(bad):
        return dict(st)
    if badrange < 0:
        raise NotImplementedError("badrange < 0 (ring rescue) is not ported")
    st = dict(st)
    if badrange > 0:
        # cross + hex4 around (0,0) are uniform -> dense; the hex2 tail
        # walks per block
        offs = _umh_uniform_offsets(badrange * pelf)
        stf = dense.check_uniform(
            {"bx": st["bx"], "by": st["by"], "bsad": st["bsad"],
             "mincost": st["mincost"]},
            offs, p.bounds, pred, lam, p.pnew, bad)
        st = dict(st, **stf)
        st = _hex2_general(probe_p, st, badrange * pelf, lam, pred,
                           active=bad)
    if pelf > 1:
        mvx, mvy = st["bx"], st["by"]
        for i in range(1, pelf):
            st = _expanding(probe_p, st, i, 1, mvx, mvy, lam, pred,
                            active=bad)
    return st


def _umh_uniform_offsets(i_me_range: int):
    """Cross + multi-hexagon offsets around (0,0) in reference order
    (pobCrossSearch PlaneOfBlocks.cpp:727-739, pobUMHSearch :742-760)."""
    offs = []
    for i in range(1, i_me_range, 2):
        offs += [(-i, 0), (i, 0)]
    for j in range(1, i_me_range, 2):
        offs += [(0, -j), (0, j)]
    hex4 = [(-4, 2), (-4, 1), (-4, 0), (-4, -1), (-4, -2), (4, -2),
            (4, -1), (4, 0), (4, 1), (4, 2), (2, 3), (0, 4), (-2, 3),
            (-2, -3), (0, -4), (2, -3)]
    i = 1
    while True:
        offs += [(ox * i, oy * i) for (ox, oy) in hex4]
        i += 1
        if i > i_me_range // 4:
            break
    return offs
