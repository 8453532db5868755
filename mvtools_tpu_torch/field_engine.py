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
* `FieldProber.check`: per-block candidates probed with the tiled probe
  kernel (ops/probe.py) — the bad-SAD rescue, which walks far from the map
  anchor.

Data-dependent search trajectories (hex2's direction walk) become
field-level loops whose candidate sets are static supersets gated by
per-block masks; the loop condition is one host read per iteration
(counted in `host_syncs`).  Candidate EVALUATION ORDER within a batch
matches the reference's enumeration: the first candidate that reaches the
batch minimum wins, as the reference's strict `cost < mincost` update does.

Not bit-exact vs the reference's sequential engine by design: neighbour
predictors lag one Jacobi iteration and badcount feedback is per-block.
Only the luma, no-overlap, plain-SAD (dct 0) path is ported.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .core.types import SearchType
from .ops import probe as probe_ops
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


class FieldProber:
    """Per-block probe evaluation through the tiled probe kernel.

    Holds the padded subplane stack and per-block static context of one
    pyramid level.  All check* methods take and return a field state dict
    of [J, nblk] tensors (bx, by, bsad, mincost, dir).
    """

    PAD = 16  # full-pel window padding beyond the frame's own padding

    def __init__(self, ctx, src_blocks, x0_a, y0_a, bounds, pnew,
                 stack=None):
        if ctx.chroma:
            raise NotImplementedError("chroma=True: only luma search is ported")
        self.ctx = ctx
        self.pel = ctx.pel
        self.logp = ctx.log_pel
        self.bs = ctx.blk_size
        self.bounds = bounds
        self.pnew = pnew
        self.src_blocks = src_blocks                  # [J, nblk, bsy, bsx] u8
        self.stack = (probe_ops.pad_stack(ctx.ref_stacks[0], self.PAD)
                      if stack is None else stack)
        # block origin in padded pel coordinates, [nblk]
        self.base_y = (y0_a + self.PAD) << self.logp
        self.base_x = (x0_a + self.PAD) << self.logp
        self.nbx = ctx.nblk[0]
        self.pitch_x = ctx.blk_size[0] - ctx.overlap[0]

    # -- raw SAD evaluation -------------------------------------------------

    def luma_sads(self, vx, vy, offsets=((0, 0),)):
        """[J, nblk, D] int64 luma SADs at per-block candidates (vx, vy) +
        static pel offsets; candidates outside their tile's window report
        INVALID_SAD."""
        cy = (self.base_y + vy)[..., None].contiguous()
        cx = (self.base_x + vx)[..., None].contiguous()
        out = probe_ops.probe_sads_tiled(
            self.stack, cy, cx, self.src_blocks, offsets, self.bs[1],
            self.bs[0], self.pel, row_len=self.nbx, pitch_x=self.pitch_x)
        return out[:, :, 0, :].to(I64)

    # -- check primitives ---------------------------------------------------

    def check(self, st, cand_x, cand_y, offsets=((0, 0),),
              penalty_new=True, update_xy=True, dir_vals=None,
              extra_mask=None, lam=None, pred=None):
        """Evaluate per-block candidates x static offsets, enumerated
        offset-major in order; the first candidate reaching the minimum
        wins if it improves on st["mincost"] (pobCheckMV
        PlaneOfBlocks.cpp:219-261)."""
        dxmin, dxmax, dymin, dymax = self.bounds
        dev = cand_x.device
        offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
        cvx = torch.minimum(torch.maximum(cand_x, dxmin), dxmax - 1)
        cvy = torch.minimum(torch.maximum(cand_y, dymin), dymax - 1)
        ls = self.luma_sads(cvx, cvy, offsets)          # [J, nblk, D]
        ox = _const(tuple(o[0] for o in offsets), I32, dev)
        oy = _const(tuple(o[1] for o in offsets), I32, dev)
        vx = cand_x[..., None] + ox
        vy = cand_y[..., None] + oy
        return _update(self, st, ls, vx, vy, lam, pred, dir_vals=dir_vals,
                       mask=extra_mask, update_xy=update_xy,
                       penalty_new=penalty_new)


def _update(p, st, ls, vx, vy, lam, pred, dir_vals=None, mask=None,
            update_xy=True, penalty_new=True):
    """Running-minimum update from SAD columns ls [J, nblk, D] at vectors
    vx/vy [J, nblk, D] already in evaluation order."""
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
    # lambda * dist >> 8 truncated through C int on purpose
    cost = ((lam[..., None] * dist.to(I64)) >> 8).to(I32).to(I64) + ls
    if penalty_new:
        cost = cost + ((p.pnew * ls) >> 8)
    cost = torch.where(ok, cost, _INF)
    best, k = _first_min(cost)
    improve = best < st["mincost"]
    st = dict(st)
    if update_xy:
        st["bx"] = torch.where(improve, _pick(vx, k), st["bx"])
        st["by"] = torch.where(improve, _pick(vy, k), st["by"])
    st["bsad"] = torch.where(improve, _pick(ls, k), st["bsad"])
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
    the anchor's alignment rounding loss."""
    align = 1 << ctx.log_pel
    return 6 + align // 2


def map_supported(ctx, r: int) -> bool:
    """Static predicate: MapProber usable on this level's geometry (8-bit,
    pel <= 2, windows fit the padded stacks)."""
    bsx, bsy = ctx.blk_size
    if ctx.bits != 8 or ctx.pel > 2 or ctx.chroma:
        return False
    pitch = bsx - ctx.overlap[0]
    tile = _map_tile(ctx)
    hp = ctx.padded[1] + 2 * FieldProber.PAD + probe_ops.ALIGN_SLACK_Y
    wp = ctx.padded[0] + 2 * FieldProber.PAD + probe_ops.ALIGN_SLACK_X
    (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
        r, r, bsy, bsx, ctx.pel, tile, pitch, hp, wp)
    return hi_y >= lo_y and hi_x >= lo_x


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

    One SAD-map kernel pass per level evaluates the whole +-R pel grid
    around a per-tile predictor anchor; every check() thereafter —
    predictor trials, the hex2 walk, expanding rings — is a gather from
    the map.  Candidates outside the grid report INVALID_SAD and lose (the
    dense zero trial bounds every block); the bad-SAD rescue keeps using a
    probe-based prober via field_epz's probe_p argument."""

    def __init__(self, ctx, src_blocks, x0_a, y0_a, bounds, pnew, pred_vx,
                 pred_vy, r: int = 0, stack=None):
        super().__init__(ctx, src_blocks, x0_a, y0_a, bounds, pnew,
                         stack=stack)
        if not r:
            r = map_radius(ctx)
        self.r = r
        logp = self.logp
        pel = self.pel
        bsx, bsy = ctx.blk_size
        nbx, nby = ctx.nblk
        pitch = self.pitch_x
        pitch_y = bsy - ctx.overlap[1]
        tile = _map_tile(ctx)
        rlp = -(-nbx // tile) * tile
        ntx = rlp // tile
        hpad = ctx.hpad[0]
        vpad = ctx.vpad[0]
        PAD = self.PAD
        dev = pred_vx.device

        # ---- anchors: per-tile med3 of the predictor field, aligned to
        # full pel, clamped so the nominal window fits the padded stack
        pvx = _row_pad(pred_vx.to(I32), nby, nbx, rlp)
        pvy = _row_pad(pred_vy.to(I32), nby, nbx, rlp)
        med_x = _med3_tiles(pvx, nby, ntx, tile)       # [J, nby, ntx]
        med_y = _med3_tiles(pvy, nby, ntx, tile)
        sh = logp
        # static block-0 source origins per tile column / block row and
        # their probe-padded stack-coordinate counterparts
        c_x = hpad + pitch * tile * np.arange(ntx, dtype=np.int64) + PAD
        c_y = vpad + pitch_y * np.arange(nby, dtype=np.int64) + PAD
        hp, wp = self.stack.shape[-2], self.stack.shape[-1]
        (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
            r, r, bsy, bsx, pel, tile, pitch, hp, wp)

        def clamp_align(av, c, lo, hi):
            """Clamp the pel-units anchor so fp = c + (av >> logp) lands
            in [lo, hi], stepping only in 2^sh units."""
            s = 1 << sh
            lo_v = -(-((lo - c) << logp) // s) * s          # ceil-align
            hi_v = (((hi - c) << logp) // s) * s            # floor-align
            lo_t = torch.as_tensor(lo_v, dtype=I32, device=dev)
            hi_t = torch.as_tensor(hi_v, dtype=I32, device=dev)
            return torch.minimum(torch.maximum(av, lo_t), hi_t)

        av_x = clamp_align((med_x >> sh) << sh, c_x[None, :], lo_x, hi_x)
        av_y = clamp_align((med_y >> sh) << sh, c_y[:, None], lo_y, hi_y)
        cx_t = torch.as_tensor(c_x, dtype=I32, device=dev)
        cy_t = torch.as_tensor(c_y, dtype=I32, device=dev)
        af_x = (cx_t[None, None, :] + (av_x >> logp)).reshape(-1, nby * ntx)
        af_y = (cy_t[None, :, None] + (av_y >> logp)).reshape(-1, nby * ntx)

        def per_block(a_tile):
            t = a_tile.repeat_interleave(tile, dim=2)
            return t[:, :, :nbx].reshape(-1, nby * nbx)

        self._av_x = per_block(av_x)                       # [J, nblk] pel
        self._av_y = per_block(av_y)
        self._m_l = sadmap.sad_map(
            self.stack, ctx.src_planes[0], af_y.contiguous(),
            af_x.contiguous(), r, r, bsy, bsx, pel, tile, pitch, pitch_y,
            nbx, nby, vpad, hpad)

    def luma_sads(self, vx, vy, offsets=((0, 0),)):
        """[J, nblk, D] int64 map values at (vx + dx, vy + dy);
        INVALID_SAD outside the grid."""
        dev = vx.device
        ox = _const(tuple(int(o[0]) for o in offsets), I32, dev)
        oy = _const(tuple(int(o[1]) for o in offsets), I32, dev)
        return self._lookup((vx - self._av_x)[..., None] + ox,
                            (vy - self._av_y)[..., None] + oy)

    def _lookup(self, rx, ry):
        """Map values at grid-relative pel vectors rx/ry [J, nblk, D]."""
        m = self._m_l
        dy_n, dx_n = m.shape[-2:]
        iy = ry + self.r
        ix = rx + self.r
        ok = (iy >= 0) & (iy < dy_n) & (ix >= 0) & (ix < dx_n)
        flat = (iy.clamp(0, dy_n - 1) * dx_n
                + ix.clamp(0, dx_n - 1)).to(I64)
        v = m.reshape(m.shape[0], m.shape[1], -1).gather(-1, flat)
        return torch.where(ok, v, probe_ops.INVALID_SAD).to(I64)

    def plain_sads_multi(self, vxs, vys):
        """[J, nblk, K] unmasked luma SADs at K clamped candidates per
        block (the predictor trials batched)."""
        return self._lookup(torch.stack(vxs, dim=-1) - self._av_x[..., None],
                            torch.stack(vys, dim=-1) - self._av_y[..., None])


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
    EXHAUSTIVE are ported."""
    if search == SearchType.EXHAUSTIVE:
        return _exhaustive(p, st, param, lam, pred, active=active)
    if search == SearchType.HEX2:
        return _hex2_general(p, st, param, lam, pred, active=active)
    raise NotImplementedError(
        f"search={SearchType(search).name}: only HEX2 and EXHAUSTIVE are "
        "ported")


def field_epz(p: FieldProber, dense, level_params, gx, gy, pred_main, preds,
              lam, idx, do_rescue: bool = True,
              probe_p: Optional[FieldProber] = None):
    """Whole-plane pseudo-EPZ for one Jacobi iteration
    (pobPseudoEPZSearch PlaneOfBlocks.cpp:819-968, dct 0, no trymany).

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
    sad0 = dense.luma_sads(0, 0)
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
    st = _update(p, st, sads[..., 2:],
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
