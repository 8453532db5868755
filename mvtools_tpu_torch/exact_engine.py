"""The exact sequential engine: the reference's Gauss-Seidel block scan,
in plain PyTorch.

This is the plain version of the CUDA kernel K6 (csrc/exact_scan.cu,
wrapper ops/exact_scan.py) and the counterpart of the JAX package's
SearchEngine(lockstep=False), _pseudo_epz and search_level
(mvtools_tpu/analyse.py:247-975).  The reference walks the blocks of a
level one after another (doPobSearchMVs PlaneOfBlocks.cpp:971-1131): each
block's left, up and up-right predictors are the vectors written moments
earlier in the same pass, a meander scan runs every other row backwards,
and the bad-SAD rescue's threshold reads a count of every earlier block's
rescue.  So the scan cannot be made parallel over the blocks of a level.

Here the blocks are walked in a Python loop in scan order, batched over a
leading axis of independent items: the jobs (frame pairs) of a level scan,
or the (job, block) pairs of Recalculate's exact search, which reads no
neighbour.  Every item keeps the reference's candidate order: a batch of
candidates takes its first strict improvement (pobCheckMV's `cost >=
nMinCost` rejects), the diamond search checks the diagonals of its switch
case in case order, and the hexagon, one-time and diamond walks run while
any item still walks, each item masked once its own walk has ended.

Costs: the plain SAD (dct 0) of uint8 or uint16 pixels, luma plus U and V
with chroma.  The motion distortion wraps in int32 as C `int` does
(pobMotionDistorsion PlaneOfBlocks.cpp:104-114); the lambda adaptation is
float64 (pobFetchPredictors :461-462).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .core.types import SearchType
from .ops import pixels

I32 = torch.int32
I64 = torch.int64
INF = 1 << 62


class ScanGeom(NamedTuple):
    """Static geometry of one level (or of Recalculate's one level)."""
    nbx: int
    nby: int
    bsx: int
    bsy: int
    bcx: int             # chroma block size
    bcy: int
    ovx: int
    ovy: int
    logx: int            # log2 of the chroma subsampling ratios
    logy: int
    hpad: int            # luma and chroma block-grid origins
    vpad: int
    hpad_c: int
    vpad_c: int
    pw: int              # luma padded extent the bounds are taken against
    ph: int
    logp: int
    bound_x: int         # hpad - (the padding a vector may reach into)
    bound_y: int
    chroma: bool


def block_origin(g: ScanGeom, blkx, blky):
    """(x0, y0, xc, yc) of block (blkx, blky), ints or tensors."""
    return (g.hpad + (g.bsx - g.ovx) * blkx, g.vpad + (g.bsy - g.ovy) * blky,
            g.hpad_c + ((g.bsx - g.ovx) >> g.logx) * blkx,
            g.vpad_c + ((g.bsy - g.ovy) >> g.logy) * blky)


def block_bounds(g: ScanGeom, x0, y0):
    """(dxmin, dxmax, dymin, dymax) of the block at (x0, y0): Analyse's
    bounds reach hpad >> level into the padding (bound_x = hpad - that),
    Recalculate's reach all of it (bound_x = 0)."""
    return (-((x0 - g.bound_x) << g.logp),
            ((g.pw - g.bsx - g.bound_x) - x0) << g.logp,
            -((y0 - g.bound_y) << g.logp),
            ((g.ph - g.bsy - g.bound_y) - y0) << g.logp)


def _col(v):
    """A per-item [N] tensor as a column [N, 1]; a Python int as it is."""
    return v[:, None] if isinstance(v, torch.Tensor) and v.ndim == 1 else v


def _clip(v, lo, hi):
    """clip(v, lo, hi) for tensors whose bounds are ints or tensors."""
    if isinstance(lo, int):
        return v.clamp(lo, hi)
    return torch.minimum(torch.maximum(v, lo), hi)


def _select(m, a, b):
    return {k: torch.where(m, a[k], b[k]) for k in a}


class Items(NamedTuple):
    """The items one engine call searches, each of them a block of a job.
    Geometry entries are Python ints (every item at the same block) or
    [N] tensors (Recalculate: an item per block)."""
    job: torch.Tensor    # [N] int64 index into the stacks' job axis
    x0: object
    y0: object
    xc: object
    yc: object
    dxmin: object
    dxmax: object
    dymin: object
    dymax: object
    src: torch.Tensor    # [N, bsy * bsx] int32 luma source block
    src_u: Optional[torch.Tensor]     # [N, bcy * bcx] int32 or None
    src_v: Optional[torch.Tensor]
    pred_x: torch.Tensor  # [N] int32 predictor of the motion distortion
    pred_y: torch.Tensor
    lam: torch.Tensor     # [N] int64 lambda


class SearchEngine:
    """Candidate evaluation and the search algorithms (pobRefine and the
    searches it calls, PlaneOfBlocks.cpp:466-816) over a batch of items,
    each with its own state: dicts of [N] tensors bx, by (int32), bsad,
    mincost (int64) and dir (int32)."""

    def __init__(self, ref_stacks, g: ScanGeom, it: Items, pnew: int):
        """ref_stacks: per plane [J, pel^2, h, w] pixels (uint8 or
        uint16)."""
        self.g = g
        self.it = it
        self.pnew = pnew
        self.pel = 1 << g.logp
        self.dev = it.src.device
        self.planes = []
        for p, stack in enumerate(ref_stacks[:3 if g.chroma else 1]):
            nj, nsub, h, w = stack.shape
            bw, bh = (g.bsx, g.bsy) if p == 0 else (g.bcx, g.bcy)
            dy = torch.arange(bh, device=self.dev)[:, None]
            dx = torch.arange(bw, device=self.dev)[None, :]
            self.planes.append((stack.reshape(-1), nsub, h, w, bh, bw,
                                (dy * w + dx).reshape(-1)))

    # -- candidate evaluation ---------------------------------------------
    def _sad(self, p, src, bx, by, vx, vy):
        """[N, K] int64 SAD of the plane-p block at pel position
        (bx << logp) + v against src [N, n]; the window start is clamped
        into the plane the way a window slice clamps it."""
        flat, nsub, h, w, bh, bw, offs = self.planes[p]
        logp, pelm = self.g.logp, self.pel - 1
        xa = (_col(bx) << logp) + vx.to(I64)
        ya = (_col(by) << logp) + vy.to(I64)
        sub = (xa & pelm) | ((ya & pelm) << logp)
        row = (ya >> logp).clamp(0, h - bh)
        col = (xa >> logp).clamp(0, w - bw)
        base = ((self.it.job[:, None] * nsub + sub) * h + row) * w + col
        ref = pixels.widen(pixels.gather(flat, base[..., None] + offs))
        return (ref - src[:, None]).abs().sum(dim=-1, dtype=I64)

    def luma_sad(self, vx, vy):
        it = self.it
        return self._sad(0, it.src, it.x0, it.y0, vx, vy)

    def chroma_sad(self, vx, vy):
        """[N, K] U + V SAD at the chroma position of the luma vector: the
        division by the subsampling ratio truncates toward zero
        (pobGetRefBlockU/V PlaneOfBlocks.cpp:57-77)."""
        if not self.g.chroma:
            return torch.zeros(vx.shape, dtype=I64, device=self.dev)
        it, g = self.it, self.g
        tx = (vx + torch.where(vx < 0, (1 << g.logx) - 1, 0)) >> g.logx
        ty = (vy + torch.where(vy < 0, (1 << g.logy) - 1, 0)) >> g.logy
        return (self._sad(1, it.src_u, it.xc, it.yc, tx, ty)
                + self._sad(2, it.src_v, it.xc, it.yc, tx, ty))

    def plain_sad(self, vx, vy):
        """[N] luma + chroma SAD at one vector per item, no bounds check."""
        return (self.luma_sad(vx[:, None], vy[:, None])
                + self.chroma_sad(vx[:, None], vy[:, None]))[:, 0]

    def motion_distortion(self, vx, vy):
        """lambda * |v - pred|^2 >> 8 through C int: the squared distance
        wraps in int32 and the product is cast back to int."""
        it = self.it
        dx = (it.pred_x[:, None] - vx).to(I32)
        dy = (it.pred_y[:, None] - vy).to(I32)
        dist = dx * dx + dy * dy
        return ((it.lam[:, None] * dist.to(I64)) >> 8).to(I32).to(I64)

    def check(self, st, vx, vy, penalty_new=True, update_xy=True,
              dir_vals=None, mask=None):
        """Evaluate the candidates [N, K] in order; the first strict
        improvement of the running minimum wins (pobCheckMV_Template
        PlaneOfBlocks.cpp:219-261).  mask [N, K] or [N, 1] leaves out
        candidates; dir_vals ([K] ints or [N, K]) sets dir on improvement."""
        it = self.it
        vx = vx.to(I32)
        vy = vy.to(I32)
        ok = ((vx >= _col(it.dxmin)) & (vy >= _col(it.dymin))
              & (vx < _col(it.dxmax)) & (vy < _col(it.dymax)))
        if mask is not None:
            ok = ok & mask
        cvx = _clip(vx, _col(it.dxmin), _col(it.dxmax) - 1)
        cvy = _clip(vy, _col(it.dymin), _col(it.dymax) - 1)
        ls = self.luma_sad(cvx, cvy)
        cs = self.chroma_sad(cvx, cvy)
        sad = ls + cs
        cost = self.motion_distortion(cvx, cvy) + sad
        if penalty_new:
            cost = cost + ((self.pnew * ls) >> 8) + ((self.pnew * cs) >> 8)
        cost = torch.where(ok, cost, INF)
        k = cost.argmin(dim=1, keepdim=True)
        ck = cost.gather(1, k)[:, 0]
        improve = ck < st["mincost"]
        new = dict(st)
        if update_xy:
            new["bx"] = torch.where(improve, vx.gather(1, k)[:, 0], st["bx"])
            new["by"] = torch.where(improve, vy.gather(1, k)[:, 0], st["by"])
        new["bsad"] = torch.where(improve, sad.gather(1, k)[:, 0], st["bsad"])
        new["mincost"] = torch.where(improve, ck, st["mincost"])
        if dir_vals is not None:
            dv = torch.as_tensor(dir_vals, dtype=I32, device=self.dev)
            dv = dv.expand(vx.shape)
            new["dir"] = torch.where(improve, dv.gather(1, k)[:, 0],
                                     st["dir"])
        return new

    def _around(self, cx, cy, offs):
        """[N, K] candidates centre + static offsets."""
        ox = torch.tensor([o[0] for o in offs], dtype=I32, device=self.dev)
        oy = torch.tensor([o[1] for o in offs], dtype=I32, device=self.dev)
        shape = (self.it.src.shape[0], len(offs))
        return ((_col(cx) + ox).expand(shape).to(I32),
                (_col(cy) + oy).expand(shape).to(I32))

    @staticmethod
    def _mask(active):
        return None if active is None else active[:, None]

    # -- search algorithms -------------------------------------------------
    def expanding(self, st, r: int, s: int, cx, cy, active=None):
        """One thin square ring (pobExpandingSearch PlaneOfBlocks.cpp:
        635-658)."""
        return self.check(st, *self._around(cx, cy, ring_offsets(r, s)),
                          mask=self._mask(active))

    def exhaustive(self, st, radius: int, active=None):
        """Rings 1..radius around the best at entry (pobRefine :786-791)."""
        offs = [o for r in range(1, radius + 1) for o in ring_offsets(r, 1)]
        return self.check(st, *self._around(st["bx"], st["by"], offs),
                          mask=self._mask(active))

    def nstep(self, st, stp: int, active=None):
        """pobNStepSearch (PlaneOfBlocks.cpp:466-485)."""
        for ln in range(stp, 0, -1):
            offs = [(ln, ln), (ln, 0), (ln, -ln), (0, -ln), (0, ln),
                    (-ln, ln), (-ln, 0), (-ln, -ln)]
            st = self.check(st, *self._around(st["bx"], st["by"], offs),
                            mask=self._mask(active))
        return st

    def _walk(self, st, length: int, fixed, start, axis: int, active):
        """The one-time search's walk along one axis: from `start`, step by
        `length` in the direction dir names while a step improves."""
        sign = torch.where(st["dir"] == 2, -1, 1).to(I32)
        going = st["dir"] != 0
        if active is not None:
            going = going & active
        st = dict(st, dir=torch.where(st["dir"] != 0, 1, 0).to(I32))
        d = start
        while bool(going.any()):
            st = dict(st, dir=torch.where(going, 0, st["dir"]).to(I32))
            d = torch.where(going, d + sign * length, d)
            step = (d + sign * length)[:, None]
            fx = _col(fixed)
            vx, vy = (step, fx) if axis == 0 else (fx, step)
            vx, vy = torch.broadcast_tensors(vx, vy)
            st = self.check(st, vx, vy, dir_vals=[1], mask=going[:, None])
            going = going & (st["dir"] != 0)
        return st, d

    def onetime(self, st, length: int, active=None):
        """pobOneTimeSearch (PlaneOfBlocks.cpp:488-527) for one length."""
        old = st
        st = dict(st, dir=torch.zeros_like(st["dir"]))
        dx0, dy0 = st["bx"], st["by"]
        m = self._mask(active)
        st = self.check(st, torch.stack([dx0 - length, dx0 + length], 1),
                        torch.stack([dy0, dy0], 1), dir_vals=[2, 1], mask=m)
        st, dx1 = self._walk(st, length, dy0, dx0, 0, active)
        st = dict(st, dir=torch.zeros_like(st["dir"]))
        st = self.check(st, torch.stack([dx1, dx1], 1),
                        torch.stack([dy0 - length, dy0 + length], 1),
                        dir_vals=[2, 1], mask=m)
        st, _ = self._walk(st, length, dx1, dy0, 1, active)
        return st if active is None else _select(active, st, old)

    def diamond(self, st, length: int, active=None):
        """pobDiamondSearch (PlaneOfBlocks.cpp:530-632): the diagonals of
        the switch case of the last direction, in case order."""
        R, L, D, U = 1, 2, 4, 8
        old = st
        st = dict(st, dir=torch.full_like(st["dir"], 15))
        going = st["dir"] > 0
        if active is not None:
            going = going & active
        table = _diamond_table(length, self.dev)
        while bool(going.any()):
            dx, dy = st["bx"], st["by"]
            last = st["dir"]
            st = dict(st, dir=torch.where(going, 0, st["dir"]).to(I32))
            bits = torch.tensor([R, L, D, U], dtype=I32, device=self.dev)
            vx = torch.stack([dx + length, dx - length, dx, dx], 1)
            vy = torch.stack([dy, dy, dy + length, dy - length], 1)
            st = self.check(st, vx, vy, dir_vals=[R, L, D, U],
                            mask=going[:, None] & ((last[:, None] & bits) != 0))
            found = st["dir"]
            imp = going & (found != 0)
            # improved: the two perpendicular directions of the new best
            dx2, dy2 = st["bx"], st["by"]
            horiz = ((found & (R + L)) != 0)[:, None]
            vx = torch.where(horiz, torch.stack([dx2, dx2], 1),
                             torch.stack([dx2 + length, dx2 - length], 1))
            vy = torch.where(horiz, torch.stack([dy2 + length, dy2 - length],
                                                1),
                             torch.stack([dy2, dy2], 1))
            dv = torch.where(horiz, torch.tensor([D, U], device=self.dev),
                             torch.tensor([R, L], device=self.dev))
            st = self.check(st, vx, vy, dir_vals=dv, mask=imp[:, None])
            # not improved: the diagonals of case `last`, in case order
            diag = going & (found == 0)
            ox, oy, dvs, valid = (t[last.clamp(0, 15).long()] for t in table)
            st = self.check(st, dx[:, None] + ox, dy[:, None] + oy,
                            dir_vals=dvs, mask=diag[:, None] & valid)
            going = going & (st["dir"] > 0)
        return st if active is None else _select(active, st, old)

    def hex2(self, st, rng: int, active=None):
        """pobHex2Search (PlaneOfBlocks.cpp:661-724)."""
        old = st
        if rng > 1:
            bmx, bmy = st["bx"], st["by"]
            st = dict(st, dir=torch.full_like(st["dir"], -2))
            offs = [(-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2)]
            st = self.check(st, *self._around(bmx, bmy, offs),
                            update_xy=False, dir_vals=[0, 1, 2, 3, 4, 5],
                            mask=self._mask(active))
            hx = torch.tensor([h[0] for h in HEX_WALK], dtype=I32,
                              device=self.dev)
            hy = torch.tensor([h[1] for h in HEX_WALK], dtype=I32,
                              device=self.dev)
            m6 = torch.tensor(HEX_MOD6M1, dtype=torch.long, device=self.dev)
            walked = st["dir"] != -2
            if active is not None:
                walked = walked & active
            d1 = (st["dir"] + 1).clamp(0, 7).long()
            bmx = torch.where(walked, bmx + hx[d1], bmx)
            bmy = torch.where(walked, bmy + hy[d1], bmy)
            i = 1
            it = self.it

            def going_now(st, bmx, bmy):
                return (walked & (i < rng // 2) & (bmx >= it.dxmin)
                        & (bmy >= it.dymin) & (bmx < it.dxmax)
                        & (bmy < it.dymax) & (st["dir"] != -2))

            going = going_now(st, bmx, bmy)
            while bool(going.any()):
                odir = m6[(st["dir"] + 1).clamp(0, 7).long()]
                odir = torch.where(going, odir, 1)
                st = dict(st, dir=torch.where(going, -2, st["dir"]).to(I32))
                idx = odir[:, None] + torch.arange(3, device=self.dev)
                vx = bmx[:, None] + hx[idx]
                vy = bmy[:, None] + hy[idx]
                st = self.check(st, vx, vy, update_xy=False,
                                dir_vals=(idx - 1).to(I32),
                                mask=going[:, None])
                moved = going & (st["dir"] != -2)
                d1 = (st["dir"] + 1).clamp(0, 7).long()
                bmx = torch.where(moved, bmx + hx[d1], bmx)
                bmy = torch.where(moved, bmy + hy[d1], bmy)
                i += 1
                going = going & going_now(st, bmx, bmy)
            st = dict(st, bx=bmx, by=bmy)
        st = self.expanding(st, 1, 1, st["bx"], st["by"], active=active)
        return st if active is None else _select(active, st, old)

    def cross(self, st, start: int, x_max: int, y_max: int, cx, cy,
              active=None):
        """pobCrossSearch (PlaneOfBlocks.cpp:727-739)."""
        offs = []
        for i in range(start, x_max, 2):
            offs += [(-i, 0), (i, 0)]
        for j in range(start, y_max, 2):
            offs += [(0, -j), (0, j)]
        if not offs:
            return st
        return self.check(st, *self._around(cx, cy, offs),
                          mask=self._mask(active))

    def umh(self, st, rng: int, cx, cy, active=None):
        """pobUMHSearch (PlaneOfBlocks.cpp:742-769)."""
        st = self.cross(st, 1, rng, rng, cx, cy, active)
        st = self.check(st, *self._around(cx, cy, umh_hex_offsets(rng)),
                        mask=self._mask(active))
        return self.hex2(st, rng, active)

    def refine(self, st, search: SearchType, param: int, active=None):
        """pobRefine (PlaneOfBlocks.cpp:772-816)."""
        if search == SearchType.ONETIME:
            i = param
            while i > 0:
                st = self.onetime(st, i, active)
                i //= 2
        elif search == SearchType.NSTEP:
            st = self.nstep(st, param, active)
        elif search == SearchType.LOGARITHMIC:
            i = param
            while i > 0:
                st = self.diamond(st, i, active)
                i //= 2
        elif search == SearchType.EXHAUSTIVE:
            st = self.exhaustive(st, param, active)
        elif search == SearchType.HEX2:
            st = self.hex2(st, param, active)
        elif search == SearchType.UMH:
            st = self.umh(st, param, st["bx"], st["by"], active)
        elif search in (SearchType.HORIZONTAL, SearchType.VERTICAL):
            line = [v for i in range(1, param + 1) for v in (-i, i)]
            offs = ([(v, 0) for v in line] if search == SearchType.HORIZONTAL
                    else [(0, v) for v in line])
            st = self.check(st, *self._around(st["bx"], st["by"], offs),
                            mask=self._mask(active))
        else:
            raise ValueError(search)
        return st


# the hexagon walk's table (pobHex2Search): entry d + 1 is the step of
# direction d, and a walk from direction d tries mod6m1[d + 1] .. + 2
HEX_WALK = ((-1, -2), (-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2),
            (-2, 0))
HEX_MOD6M1 = (5, 0, 1, 2, 3, 4, 5, 0)
UMH_HEX4 = ((-4, 2), (-4, 1), (-4, 0), (-4, -1), (-4, -2), (4, -2), (4, -1),
            (4, 0), (4, 1), (4, 2), (2, 3), (0, 4), (-2, 3), (-2, -3),
            (0, -4), (2, -3))


def ring_offsets(r: int, s: int):
    """The offsets of a thin square ring of radius r and step s, in the
    reference's order (pobExpandingSearch)."""
    offs = []
    for i in range(-r + s, r, s):
        offs += [(i, -r), (i, r)]
    for j in range(-r + s, r, s):
        offs += [(-r, j), (r, j)]
    return offs + [(-r, -r), (-r, r), (r, -r), (r, r)]


def umh_hex_offsets(rng: int):
    """The UMH's scaled hexagons: scales 1 .. max(1, rng // 4)."""
    return [(ox * i, oy * i) for i in range(1, max(1, rng // 4) + 1)
            for ox, oy in UMH_HEX4]


def diamond_cases(length: int):
    """Per switch case 0..15 of pobDiamondSearch's last direction, the
    diagonals it checks, in case order: a list of ((dx, dy), dir)."""
    R, L, D, U = 1, 2, 4, 8
    pp, mp, pm, mm = ((length, length), (-length, length),
                      (length, -length), (-length, -length))
    diag = {pp: R + D, mp: L + D, pm: R + U, mm: L + U}
    cases = {R: (pp, pm), L: (mp, mm), D: (pp, mp), U: (pm, mm),
             R + D: (pp, mp, pm), L + D: (pp, mp, mm),
             R + U: (pp, mm, pm), L + U: (mm, mp, pm)}
    return [[(o, diag[o]) for o in cases.get(c, (pp, mp, pm, mm))]
            for c in range(16)]


def _diamond_table(length: int, dev):
    """(ox, oy, dir, valid) [16, 4] tensors of diamond_cases, padded."""
    rows = diamond_cases(length)
    ox = torch.zeros((16, 4), dtype=I32)
    oy = torch.zeros((16, 4), dtype=I32)
    dv = torch.zeros((16, 4), dtype=I32)
    valid = torch.zeros((16, 4), dtype=torch.bool)
    for c, row in enumerate(rows):
        for k, ((x, y), d) in enumerate(row):
            ox[c, k], oy[c, k], dv[c, k], valid[c, k] = x, y, d, True
    return tuple(t.to(dev) for t in (ox, oy, dv, valid))


# ---------------------------------------------------------------------------
# Per-block pseudo-EPZ search (pobPseudoEPZSearch PlaneOfBlocks.cpp:819-968)


def pseudo_epz(eng: SearchEngine, plan: dict, zs, gx, gy, pred, preds,
               blkidx, badcount):
    """The search of one block for every item.  zs: [N] field shift; gx,
    gy: [N] global predictor (pel-scaled, gy with the field shift); pred:
    (x, y) main predictor; preds: four (x, y) predictors; blkidx: the
    block's index (int or [N]); badcount: [N] int32.  Returns (state,
    badcount)."""
    search, param = plan["search"], plan["param"]
    trymany = plan["trymany"]
    verybig = plan["verybig"]
    it = eng.it
    zx = torch.zeros_like(zs)
    sad0 = (eng.luma_sad(zx[:, None], zs[:, None])
            + eng.chroma_sad(zx[:, None], zx[:, None]))[:, 0]
    st = dict(bx=zx, by=zs, bsad=sad0,
              mincost=sad0 + ((plan["pzero"] * sad0) >> 8),
              dir=torch.zeros_like(zs))
    results = []
    if trymany:
        st = eng.refine(st, search, param)
        results.append(st)

    def take_trial(st, vx, vy, cost_of):
        sad = eng.plain_sad(vx, vy)
        cost = cost_of(sad)
        take = (cost < st["mincost"]) | trymany
        return dict(st, bx=torch.where(take, vx, st["bx"]),
                    by=torch.where(take, vy, st["by"]),
                    bsad=torch.where(take, sad, st["bsad"]),
                    mincost=torch.where(take, cost, st["mincost"]))

    gxc = _clip(gx, it.dxmin, it.dxmax - 1)
    gyc = _clip(gy, it.dymin, it.dymax - 1)
    st = take_trial(st, gxc, gyc,
                    lambda s: s + ((plan["pglobal"] * s) >> 8))
    if trymany:
        st = eng.refine(st, search, param)
        results.append(st)
    st = take_trial(st, pred[0], pred[1], lambda s: s)
    if trymany:
        st = eng.refine(st, search, param)
        results.append(st)
    for qx, qy in preds:
        if trymany:
            st = dict(st, mincost=torch.full_like(st["mincost"],
                                                  verybig + 1))
        st = eng.check(st, qx[:, None], qy[:, None], penalty_new=False)
        if trymany:
            st = eng.refine(st, search, param)
            results.append(st)
    if trymany:
        costs = torch.stack([r["mincost"] for r in results])
        k = costs.argmin(dim=0, keepdim=True)
        ck = costs.gather(0, k)[0]
        improve = ck < verybig + 1

        def pick(key):
            return torch.stack([r[key] for r in results]).gather(0, k)[0]

        st = dict(st, bx=torch.where(improve, pick("bx"), st["bx"]),
                  by=torch.where(improve, pick("by"), st["by"]),
                  bsad=torch.where(improve, pick("bsad"), st["bsad"]),
                  mincost=torch.where(improve, ck, st["mincost"]))
    else:
        st = eng.refine(st, search, param)

    # ---- bad-SAD rescue (PlaneOfBlocks.cpp:938-963) ----------------------
    badsad = plan["badsad"]
    found = st["bsad"]
    bad = (torch.as_tensor(blkidx, device=eng.dev) > 1) & (
        found > badsad + badsad * badcount.to(I64) // 16)
    if bool(bad.any()):
        st = _select(bad, rescue(eng, plan, st, found, bad), st)
    return st, badcount + bad.to(I32)


def rescue(eng: SearchEngine, plan: dict, st, found, active):
    """UMH around zero (badrange > 0) or rings around zero with an early
    break (badrange < 0), then the sub-pel rings around the result."""
    badrange = plan["badrange"]
    pelf = eng.pel
    if badrange > 0:
        st = eng.umh(st, badrange * pelf, 0, 0, active)
    elif badrange < 0:
        done = torch.zeros_like(active)
        for i in range(1, -badrange * pelf, pelf):
            act = active & ~done
            if not bool(act.any()):
                break
            st = eng.expanding(st, i, pelf, 0, 0, act)
            done = done | (act & (st["bsad"] < found // 4))
    mvx, mvy = st["bx"], st["by"]
    for i in range(1, pelf):
        st = eng.expanding(st, i, 1, mvx, mvy, active)
    return st


def _median3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def search_level(src_planes, ref_stacks, g: ScanGeom, plan: dict,
                 vectors_in, gx, gy, zs):
    """Search all blocks of one level for a batch of jobs, block after
    block in scan order (doPobSearchMVs PlaneOfBlocks.cpp:971-1131; the
    JAX package's search_level).

    src_planes: per plane [J, h, w] pixels (the source's subplane 0);
    ref_stacks: per plane [J, pel^2, h, w]; vectors_in: (x, y, sad)
    [J, nblk] interpolated predictions (zeros at the coarsest level); gx,
    gy: [J] int32 pel-scaled global predictor, gy with the field shift;
    zs: [J] int32 field shift.  Returns ((x, y, sad), badcount [J]
    int32)."""
    nbx, nby = g.nbx, g.nby
    vx, vy, vs = (t.clone() for t in vectors_in)
    dev = vx.device
    nj = vx.shape[0]
    jobs = torch.arange(nj, device=dev)
    badcount = torch.zeros((nj,), dtype=I32, device=dev)
    no_sad = torch.zeros((nj,), dtype=I64, device=dev)
    smallest = plan["smallest_plane"]
    lsad_f = float(plan["lsad"])
    zs = zs.to(I32)
    gx = gx.to(I32)
    gy = gy.to(I32)
    zero = torch.zeros_like(zs)

    for i in range(nbx * nby):
        blky, iblkx = divmod(i, nbx)
        fwd = not plan["meander"] or blky % 2 == 0
        sdir = 1 if fwd else -1
        blkx = iblkx if fwd else nbx - 1 - iblkx
        blkidx = blky * nbx + blkx
        x0, y0, xc, yc = block_origin(g, blkx, blky)
        dxmin, dxmax, dymin, dymax = block_bounds(g, x0, y0)

        def clip(x, y):
            return x.clamp(dxmin, dxmax - 1), y.clamp(dymin, dymax - 1)

        def nbr(ok, idx):
            if ok:
                return vx[:, idx], vy[:, idx], vs[:, idx]
            return zero, zs, no_sad

        # predictors (pobFetchPredictors PlaneOfBlocks.cpp:419-463)
        left_ok = blkx > 0 if sdir == 1 else blkx < nbx - 1
        p1x, p1y, p1s = nbr(left_ok, blkidx - sdir)
        p1x, p1y = clip(p1x, p1y)
        up_ok = blky > 0
        p2x, p2y, p2s = nbr(up_ok, blkidx - nbx)
        p2x, p2y = clip(p2x, p2y)
        x_ok = blkx < nbx - 1 if sdir == 1 else blkx > 0
        if blky < nby - 1 and x_ok:
            p3x, p3y, p3s = nbr(True, blkidx + nbx + sdir)
        else:
            p3x, p3y, p3s = nbr(up_ok and x_ok, blkidx - nbx + sdir)
        p3x, p3y = clip(p3x, p3y)
        if up_ok:
            p0x, p0y = _median3(p1x, p2x, p3x), _median3(p1y, p2y, p3y)
            p0s = torch.maximum(p1s, torch.maximum(p2s, p3s))
        else:
            p0x, p0y, p0s = p1x, p1y, p1s
        if smallest:
            prx, pry, prs = p0x, p0y, p0s
        else:
            prx, pry = clip(vx[:, blkidx], vy[:, blkidx])
            prs = vs[:, blkidx]
        # lambda adaptation in C doubles, truncated toward zero
        lam0 = 0.0 if blky == 0 else float(plan["lambda_level"])
        scale = lsad_f / (lsad_f + (prs >> 1).to(torch.float64))
        lam = ((lam0 * scale) * scale).to(I64)

        src = [pixels.widen(src_planes[0][:, y0:y0 + g.bsy, x0:x0 + g.bsx])]
        if g.chroma:
            src += [pixels.widen(p[:, yc:yc + g.bcy, xc:xc + g.bcx])
                    for p in src_planes[1:3]]
        items = Items(jobs, x0, y0, xc, yc, dxmin, dxmax, dymin, dymax,
                      src[0].reshape(nj, -1),
                      src[1].reshape(nj, -1) if g.chroma else None,
                      src[2].reshape(nj, -1) if g.chroma else None,
                      prx, pry, lam)
        eng = SearchEngine(ref_stacks, g, items, plan["pnew"])
        st, badcount = pseudo_epz(
            eng, plan, zs, gx, gy, (prx, pry),
            ((p0x, p0y), (p1x, p1y), (p2x, p2y), (p3x, p3y)), blkidx,
            badcount)
        vx[:, blkidx] = st["bx"]
        vy[:, blkidx] = st["by"]
        vs[:, blkidx] = st["bsad"]
    return (vx, vy, vs), badcount


def search_items(src_planes, ref_stacks, g: ScanGeom, search: SearchType,
                 param: int, pred_x, pred_y, lambda_level: int, pnew: int,
                 thsad: int):
    """Recalculate's exact search (pobRecalculateMVs PlaneOfBlocks.cpp:
    1158-1424; the JAX package's per-block engine with lockstep=False):
    every block of every job at once, an item each.  pred_x, pred_y:
    [J, nblk] int32 predictors (before clipping).  A block starts at its
    clipped predictor with the plain SAD there as its cost and keeps the
    refined vector only if that SAD exceeds thsad.  Returns (x, y, sad)
    [J, nblk]."""
    nj, nblk = pred_x.shape
    dev = pred_x.device
    b = torch.arange(nblk, device=dev)
    blkx = (b % g.nbx).repeat(nj)
    blky = (b // g.nbx).repeat(nj)
    jobs = torch.arange(nj, device=dev).repeat_interleave(nblk)
    x0, y0, xc, yc = block_origin(g, blkx, blky)
    dxmin, dxmax, dymin, dymax = block_bounds(g, x0, y0)
    cpx = _clip(pred_x.reshape(-1), dxmin, dxmax - 1).to(I32)
    cpy = _clip(pred_y.reshape(-1), dymin, dymax - 1).to(I32)
    lam = torch.where(blky == 0, 0, lambda_level).to(I64)

    def blocks(plane, x, y, bh, bw):
        rows = (y[:, None] + torch.arange(bh, device=dev))[:, :, None]
        cols = (x[:, None] + torch.arange(bw, device=dev))[:, None, :]
        return pixels.widen(pixels.gather(
            plane, (jobs[:, None, None], rows, cols))).reshape(len(x), -1)

    src = blocks(src_planes[0], x0, y0, g.bsy, g.bsx)
    su = sv = None
    if g.chroma:
        su = blocks(src_planes[1], xc, yc, g.bcy, g.bcx)
        sv = blocks(src_planes[2], xc, yc, g.bcy, g.bcx)
    items = Items(jobs, x0, y0, xc, yc, dxmin, dxmax, dymin, dymax, src, su,
                  sv, cpx, cpy, lam)
    eng = SearchEngine(ref_stacks, g, items, pnew)
    sad0 = eng.plain_sad(cpx, cpy)
    st = dict(bx=cpx, by=cpy, bsad=sad0, mincost=sad0,
              dir=torch.zeros_like(cpx))
    bad = sad0 > thsad
    st = _select(bad, eng.refine(st, search, param, active=bad), st)
    return tuple(st[k].reshape(nj, nblk) for k in ("bx", "by", "bsad"))
