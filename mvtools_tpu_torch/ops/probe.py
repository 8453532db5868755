"""Candidate probes and reference-block fetches on a pel-subplane stack.

The reference's innermost loop is one SAD per candidate vector per block
(pobCheckMV_Template PlaneOfBlocks.cpp:219-261 over pobGetRefBlock's
pel-plane pointer math :34-54).  Four operations live here, each as a CUDA
kernel (csrc/probe.cu, csrc/probe_block.cu, csrc/fetch.cu) with a plain
PyTorch version beside it:

* probe_sads — [J, nblk, K, D] int32 SADs for K candidate centres per block
  times D static pel offsets, one window per (block, candidate); every entry
  is a real SAD.  It serves the planes that are too small for the tiled
  probe's shared window (the coarse pyramid levels, small chroma planes).
* probe_sads_tiled — [J, nblk, K, D] int32 SADs for K candidate centres per
  block times D static pel offsets, with the tile-extent validity rule:
  candidates whose window leaves their tile's shared window report
  INVALID_SAD and lose every cost comparison.  A plane smaller than the tile
  window goes to probe_sads instead.
* fetch_blocks_tiled — [J, nblk, K, bs_y, bs_x] int32 reference blocks at pel
  positions of a block grid, exact for every block, the full-pel origin
  taken into the plane as a whole, the way a window slice takes it
  (wrap_clamp).  A stack smaller than the tile window goes to fetch_blocks
  instead.
* fetch_blocks — the same function for any stack and candidate set.  It
  serves the DCT costs (dct 1-4), whose candidates are DCT-transformed
  after the fetch.  The two fetches share one CUDA kernel and differ in
  their hand-over and launch count only.

Both probes also come in a three-stat form (stats="sad_satd_luma"): every
entry is the triple (SAD, SATD, sum of the reference block) that the SATD
cost modes (dct 5-10) mix, output [..., 3].  It is a kernel of its own in
the same source file, defined for 8-bit stacks and the block sizes the SATD
exists for.

Stacks and source blocks are uint8, or uint16 for clips of 9 to 16 bits;
each kernel has a form for either, chosen by the stack's dtype, and counts
the launches of its uint16 form under its name with "[u16]" appended.

A wrapper launches its kernel when the tensors are on a CUDA device and
uses the plain version only for CPU tensors.

Coordinates: candidates are PEL-space positions of the block origin
including the frame padding and the extra probe padding applied by
pad_stack, i.e. (hpad + probe_pad + x) * pel + vx.  The job axis J is an
explicit leading axis everywhere.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build, pixels
from . import sad as sad_ops
from .pad import edge_pad

I32 = torch.int32

# Extra bottom/right padding of a probe stack.  The sizes come from the
# window alignment of the first implementation of these probes; they stay
# because they are part of the result: anchor clamps (sadmap.anchor_bounds)
# and tile-window clamps (_tile_base) are taken against the padded extent,
# so they decide which candidates fall off a map or a tile.
ALIGN_SLACK_Y = 64
ALIGN_SLACK_X = 384

INVALID_SAD = 2147483647   # int32 max

STATS = ("sad", "sad_satd_luma")

# one count per kernel; the three-stat and the uint16 forms are kernels of
# their own
launches = {"probe_sads": 0, "probe_sads_tiled": 0, "fetch_blocks_tiled": 0,
            "fetch_blocks": 0, "probe_sads[stats3]": 0,
            "probe_sads_tiled[stats3]": 0, "probe_sads[u16]": 0,
            "probe_sads_tiled[u16]": 0, "fetch_blocks_tiled[u16]": 0,
            "fetch_blocks[u16]": 0}
plain_calls_on_cuda = 0    # plain versions run on CUDA tensors (comparisons)


def pad_stack(stack: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-pad every subplane of a [..., pel^2, ph, pw] stack by `pad`
    full-pel pixels, plus ALIGN_SLACK on the bottom/right."""
    return edge_pad(stack, pad, pad + ALIGN_SLACK_Y, pad, pad + ALIGN_SLACK_X)


def _window_geom(offsets, bs_y: int, bs_x: int, pel: int):
    """Full-pel window size and base pel-offset for a static offset set."""
    logp = pel.bit_length() - 1
    min_dx = min(o[0] for o in offsets)
    max_dx = max(o[0] for o in offsets)
    min_dy = min(o[1] for o in offsets)
    max_dy = max(o[1] for o in offsets)
    # full-pel span: positions (c+d)>>logp for d in [min_d, max_d]
    wy = bs_y + ((max_dy >> logp) - (min_dy >> logp)) + 1
    wx = bs_x + ((max_dx >> logp) - (min_dx >> logp)) + 1
    return min_dx, min_dy, wy, wx


def _tile_geom(offsets, bs_y: int, bs_x: int, pel: int):
    """(min_dx, min_dy, wy, wx, rows2, cxs): logical window of the offset
    set plus the two rounded sizes the validity rule is stated in (rows2:
    rows to a multiple of 8, cxs: columns + 127 to a multiple of 128)."""
    min_dx, min_dy, wy, wx = _window_geom(offsets, bs_y, bs_x, pel)
    rows2 = -(-wy // 8) * 8
    cxs = -(-(wx + 127) // 128) * 128
    return min_dx, min_dy, wy, wx, rows2, cxs


def tile_params(offsets, bs_y: int, bs_x: int, pel: int, tile: int,
                pitch_x: int, margin_y: int = 20, margin_x: int = 64):
    """Static tile-window extents and anchor centering for
    probe_sads_tiled.

    pitch_x: full-pel distance between consecutive blocks' window bases;
    margins are the tolerated full-pel MV deviation from the tile anchor."""
    _, _, wy, wx, rows2, cxs = _tile_geom(offsets, bs_y, bs_x, pel)
    wy_total = -(-(max(rows2, wy + 2 * margin_y)) // 32) * 32
    span = (tile - 1) * pitch_x
    wx_total = -(-(span + cxs + 2 * margin_x) // 128) * 128
    center_y = margin_y
    center_x = (tile // 2) * pitch_x + margin_x
    return wy_total, wx_total, center_y, center_x


@functools.lru_cache(maxsize=None)
def _tile_window(offsets: tuple, bs_y: int, bs_x: int, pel: int, tile: int,
                 pitch_x: int, margin_y: int, margin_x: int):
    """tile_params of a canonical offset set (_offset_window), made once."""
    return tile_params(offsets, bs_y, bs_x, pel, tile, pitch_x, margin_y,
                       margin_x)


def _med3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def _tile_base(wb0, wbm, wb1, center: int, lo_max: int, align_mask: int):
    """Clamped, aligned-down tile window base from the med3 anchor."""
    base = (_med3(wb0, wbm, wb1) - center).clamp(0, lo_max)
    return base & align_mask


@functools.lru_cache(maxsize=None)
def _offsets_tensor(offsets: tuple, device) -> torch.Tensor:
    """[D, 2] int32 (dx, dy) device table of a static offset set, made once
    per set and device."""
    return torch.tensor([[int(dx), int(dy)] for dx, dy in offsets],
                        dtype=I32, device=device)


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device=None):
    """Raise unless t is a contiguous ndim-d tensor of `dtype` (or of one
    of a tuple of dtypes) on `device` (if given)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {ndim}-d {dtype} tensor, got "
            f"{tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_stats(what: str, stats: str, stack) -> bool:
    """True for the three-stat form.  It is defined for 8-bit stacks only
    and needs a block size the SATD exists for."""
    if stats not in STATS:
        raise ValueError(f"{what}: stats must be one of {STATS}")
    if stats == "sad":
        return False
    if stack.dtype != torch.uint8:
        raise ValueError(f"{what}: the stats path supports 8-bit stacks only")
    return True


def _block_costs(ref, src, stats3: bool):
    """SAD [...] of int32 blocks ref against src over the last two axes, or
    with stats3 the triple (SAD, SATD, sum of the reference block)
    [..., 3]."""
    s = (ref - src).abs().sum(dim=(-2, -1))
    if not stats3:
        return s
    return torch.stack((s, sad_ops.satd(src, ref),
                        ref.sum(dim=(-2, -1))), dim=-1)


def wrap_clamp(start, size: int, n: int):
    """The start of an n-long window of a size-long axis the way a JAX
    window slice (lax.dynamic_slice) takes it, and so the JAX package's
    CPU paths and its Pallas kernels run in interpret mode: a negative
    start wraps once round the axis, then the window is clamped inside it.
    The search keeps every window inside the padded stack, where this is
    the start itself."""
    return torch.where(start < 0, start + size, start).clamp(0, size - n)


def _gather_at(stack, sub, fy, fx, bs_y: int, bs_x: int):
    """int32 [..., bs_y, bs_x] patches of stack [J, n_sub, H, W] from
    subplane `sub` at full-pel origin (fy, fx), all [J, ...]; rows/columns
    clamped into the plane."""
    nj, n_sub, hp, wp = stack.shape
    dev = stack.device
    gy = (fy[..., None, None]
          + torch.arange(bs_y, device=dev)[:, None]).clamp(0, hp - 1)
    gx = (fx[..., None, None]
          + torch.arange(bs_x, device=dev)[None, :]).clamp(0, wp - 1)
    job = torch.arange(nj, device=dev).reshape((nj,) + (1,) * (gy.ndim - 1))
    flat = ((job * n_sub + sub[..., None, None]) * hp + gy) * wp + gx
    return pixels.widen(pixels.gather(stack.reshape(-1), flat))


def _gather_blocks_plain(stack, pos_y, pos_x, bs_y: int, bs_x: int, logp: int):
    """int32 [..., bs_y, bs_x] patches of stack [J, n_sub, H, W] at pel
    positions pos_y/pos_x [J, ...]; rows/columns clamped into the plane."""
    pelm = (1 << logp) - 1
    sub = (pos_x & pelm) | ((pos_y & pelm) << logp)
    return _gather_at(stack, sub, pos_y >> logp, pos_x >> logp, bs_y, bs_x)


# ---------------------------------------------------------------------------
# K4: per-block probe


@functools.lru_cache(maxsize=None)
def _offset_window(offsets: tuple, bs_y: int, bs_x: int, pel: int):
    """(offsets as a tuple of int pairs, min_dx, min_dy, wy, wx): an offset
    set made canonical once, with its window (_window_geom)."""
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    return (offsets,) + _window_geom(offsets, bs_y, bs_x, pel)


def _offset_set(offsets, bs_y: int, bs_x: int, pel: int):
    """_offset_window of any offset sequence (a tuple is looked up as it
    is)."""
    try:
        return _offset_window(offsets, bs_y, bs_x, pel)
    except TypeError:                   # unhashable: a list, or lists in it
        return _offset_window(tuple(tuple(o) for o in offsets), bs_y, bs_x,
                              pel)


def probe_sads_plain(stack, cand_y, cand_x, src_blocks, offsets, bs_y: int,
                     bs_x: int, pel: int, stats: str = "sad",
                     active=None) -> torch.Tensor:
    """Plain PyTorch version of the per-block probe (same contract as the
    kernel, either form).  Out-of-range rule: the window of the whole offset set is
    shifted as a whole into the plane and each offset's block keeps its
    place inside it — what a window slice (wrap_clamp) followed by an
    in-window slice does.  active: None, or a bool tensor that broadcasts
    to [J, nblk, K, D]; an inactive entry reports INVALID_SAD (in all
    three)."""
    global plain_calls_on_cuda
    if stack.is_cuda:
        plain_calls_on_cuda += 1
    stats3 = _check_stats("probe_sads", stats, stack)
    logp = pel.bit_length() - 1
    pelm = pel - 1
    min_dx, min_dy, wy, wx = _window_geom(offsets, bs_y, bs_x, pel)
    hp, wp = stack.shape[-2:]
    wb_y = (cand_y + min_dy) >> logp
    wb_x = (cand_x + min_dx) >> logp
    shift_y = wrap_clamp(wb_y, hp, wy) - wb_y
    shift_x = wrap_clamp(wb_x, wp, wx) - wb_x
    src = pixels.widen(src_blocks)[:, :, None]              # [J, nblk, 1, ..]
    cols = []
    for dx, dy in offsets:
        ay = cand_y + dy
        ax = cand_x + dx
        sub = (ax & pelm) | ((ay & pelm) << logp)
        ref = _gather_at(stack, sub, (ay >> logp) + shift_y,
                         (ax >> logp) + shift_x, bs_y, bs_x)
        cols.append(_block_costs(ref, src, stats3))
    out = torch.stack(cols, dim=3).to(I32)
    return out if active is None else _invalid_where(active, out)


# CTA sizes of the per-block probe, largest first
PROBE_BLOCK_THREADS = (256, 128, 64, 32)


def probe_block_launch_geom(bs_y: int, bs_x: int, n_entries: int, u16: bool,
                            n_sm: int) -> dict:
    """Launch geometry of the per-block probe (K4,
    csrc/probe_block.cu::probe_block_kernel<T, CW, HALF>) for a block size,
    n_entries (job, block, candidate, offset) entries and a card of n_sm
    SMs.

    A block row is `wpr` 32-bit words (half a word where a uint8 block is
    2 pixels wide: `half`), cut in parts of `cw` words (the most of 4, 2, 1
    that divide the row; 2**lppr parts a row).  `g` = 2**lg lanes take one
    entry, `parts` parts each (part q of the block: lane q % g), so every
    offset of an item is in flight at once.  CTAs of `threads` lanes, the
    largest of PROBE_BLOCK_THREADS that still gives each SM a CTA (32 where
    none does), `ctas` of them.  Widths the kernel does not take raise."""
    ppw = 2 if u16 else 4
    half = not u16 and bs_x == 2
    if bs_y < 1 or bs_x < 1 or (not half and bs_x % ppw):
        raise ValueError(f"probe_sads: no kernel for {bs_x}-pixel-wide "
                         f"{'uint16' if u16 else 'uint8'} blocks")
    wpr = 1 if half else bs_x // ppw
    cw = next(c for c in (4, 2, 1) if wpr % c == 0)
    ppr = wpr // cw
    if ppr & (ppr - 1):
        raise ValueError(f"probe_sads: no kernel for {bs_x}-pixel-wide "
                         "blocks (the parts of a row must be a power of 2)")
    n_parts = bs_y * ppr
    g = min(32, n_parts & -n_parts)
    lanes = n_entries * g
    threads = next((t for t in PROBE_BLOCK_THREADS
                    if -(-lanes // t) >= n_sm), PROBE_BLOCK_THREADS[-1])
    return dict(cw=cw, half=half, g=g, lg=g.bit_length() - 1,
                parts=n_parts // g, lppr=ppr.bit_length() - 1,
                threads=threads, ctas=-(-lanes // threads))


# the ints of a per-block probe launch, in the order mvt_probe_sads reads
# them (csrc/probe_block.cu::K4Arg)
_PROBE_BLOCK_ARGS = ("n_jobs", "n_sub", "hp", "wp", "nblk", "k", "d", "bs_y",
                     "bs_x", "logp", "min_dy", "min_dx", "wy", "wx", "u16",
                     "cw", "half", "lg", "parts", "lppr", "threads")


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _probe_block_launch(offsets: tuple, bs_y: int, bs_x: int, pel: int,
                        u16: bool, stack_shape, cand_shape, device,
                        stats3: bool = False):
    """(offsets table, the launch's ints as a ctypes array) of a per-block
    probe call (stats3: of the three-stat form): everything but the
    pointers, made once per offset set, block size, shapes and device."""
    _, min_dx, min_dy, wy, wx = _offset_window(offsets, bs_y, bs_x, pel)
    nj, n_sub, hp, wp = stack_shape
    _, nblk, kk = cand_shape
    n, n_sm = nj * nblk * kk * len(offsets), _sm_count(device.index)
    g = (probe_block3_launch_geom(bs_y, bs_x, n, n_sm) if stats3
         else probe_block_launch_geom(bs_y, bs_x, n, u16, n_sm))
    vals = dict(n_jobs=nj, n_sub=n_sub, hp=hp, wp=wp, nblk=nblk, k=kk,
                d=len(offsets), bs_y=bs_y, bs_x=bs_x,
                logp=pel.bit_length() - 1, min_dy=min_dy, min_dx=min_dx,
                wy=wy, wx=wx, u16=int(u16), **{k: int(v) for k, v in g.items()
                                               if k != "ctas"})
    names = _PROBE_BLOCK3_ARGS if stats3 else _PROBE_BLOCK_ARGS
    args = (ctypes.c_int * len(names))(*(vals[k] for k in names))
    return _offsets_tensor(offsets, device), args


def probe_block3_launch_geom(bs_y: int, bs_x: int, n_entries: int,
                             n_sm: int) -> dict:
    """Launch geometry of the three-stat per-block probe (K4',
    csrc/probe_block.cu::probe_block_stats3_kernel<TILE4>) for a block size
    with a SATD (sad.satd_supported), n_entries (job, block, candidate,
    offset) entries and a card of n_sm SMs.

    A block is (bs_y / 4) x (bs_x / 8) partitions of 8x4 pixels (2**lpx a
    row), or one 4x4 tile (`tile4`); `g` = 2**lg lanes (at most 32) take
    one entry, `parts` partitions each (partition q: lane q % g).  CTAs as
    probe_block_launch_geom takes them."""
    if not sad_ops.satd_supported(bs_x, bs_y):
        raise ValueError(f"probe_sads: no SATD for block size {bs_x}x{bs_y}")
    tile4 = bs_x == 4
    ppr = 1 if tile4 else bs_x // 8
    n_parts = 1 if tile4 else (bs_y // 4) * ppr
    g = min(32, n_parts)
    lanes = n_entries * g
    threads = next((t for t in PROBE_BLOCK_THREADS
                    if -(-lanes // t) >= n_sm), PROBE_BLOCK_THREADS[-1])
    return dict(tile4=tile4, g=g, lg=g.bit_length() - 1,
                parts=n_parts // g, lpx=ppr.bit_length() - 1,
                threads=threads, ctas=-(-lanes // threads))


# the ints of a three-stat per-block probe launch, in the order
# mvt_probe_sads_stats3 reads them (csrc/probe_block.cu::K4pArg)
_PROBE_BLOCK3_ARGS = ("n_jobs", "n_sub", "hp", "wp", "nblk", "k", "d",
                      "bs_y", "bs_x", "logp", "min_dy", "min_dx", "wy", "wx",
                      "tile4", "lg", "parts", "lpx", "threads")


@functools.lru_cache(maxsize=None)
def _probe_block_fn(stats3: bool):
    fn = getattr(cuda_build.load("probe_block"),
                 "mvt_probe_sads_stats3" if stats3 else "mvt_probe_sads")
    fn.argtypes = [ctypes.c_void_p] * 7 \
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _on_device(dev, fn, *args):
    """fn(*args) with `dev` the current CUDA device (a kernel launches on
    the current device's stream)."""
    if torch.cuda.current_device() == dev.index:
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _stream(dev) -> int:
    """The handle of CUDA device dev's current stream: what
    torch.cuda.current_stream(dev).cuda_stream gives, without making a
    Stream object (a tenth of its host time; the call Triton's launcher
    makes)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _launch_name(name: str, stack) -> str:
    """The launch count of a kernel's form for this stack's dtype (the
    three-stat forms take uint8 stacks only)."""
    return name + "[u16]" if stack.dtype == torch.uint16 else name


def _check_probe_args(what, stack, cand_y, cand_x, src_blocks, bs_y, bs_x,
                      pel, stats3=False):
    if stack.dtype not in pixels.PIXEL_DTYPES:
        raise NotImplementedError(
            f"{what}: only 8-bit (uint8) and 9- to 16-bit (uint16) stacks "
            f"are ported, got {stack.dtype}")
    if stats3 and not sad_ops.satd_supported(bs_x, bs_y):
        raise ValueError(f"{what}: no SATD for block size {bs_x}x{bs_y}")
    if pel not in (1, 2, 4):
        raise ValueError(f"{what}: pel must be 1, 2 or 4")
    dev = stack.device
    _check(stack, "stack", pixels.PIXEL_DTYPES, 4)
    _check(cand_y, "cand_y", I32, 3, dev)
    _check(cand_x, "cand_x", I32, 3, dev)
    _check(src_blocks, "src_blocks", stack.dtype, 4, dev)
    nj, nblk, _ = cand_y.shape
    if (cand_x.shape != cand_y.shape or stack.shape[0] != nj
            or stack.shape[1] != pel * pel
            or tuple(src_blocks.shape) != (nj, nblk, bs_y, bs_x)):
        raise ValueError(f"{what}: inconsistent shapes")


def probe_sads(stack, cand_y, cand_x, src_blocks, offsets, bs_y: int,
               bs_x: int, pel: int, stats: str = "sad",
               active=None) -> torch.Tensor:
    """[J, nblk, K, D] int32 SADs, one window per (block, candidate); with
    stats="sad_satd_luma" [J, nblk, K, D, 3] triples (SAD, SATD, sum of the
    reference block).

    stack: [J, pel^2, Hp, Wp] uint8 or uint16 pad_stack output;
    cand_y/cand_x: [J, nblk, K] int32 candidate pel positions (see module
    doc); src_blocks: [J, nblk, bs_y, bs_x] of the stack's dtype; offsets:
    static [(dx, dy), ...] pel offsets evaluated per candidate; active:
    optional bool tensor that broadcasts to [J, nblk, K, D] (None: all): an
    inactive entry reads no pixel and reports INVALID_SAD (in all three).
    The kernel serves every call on CUDA tensors, however few the
    blocks."""
    offsets, _, _, wy, wx = _offset_set(offsets, bs_y, bs_x, pel)
    stats3 = _check_stats("probe_sads", stats, stack)
    _check_probe_args("probe_sads", stack, cand_y, cand_x, src_blocks, bs_y,
                      bs_x, pel, stats3)
    if stack.shape[2] < wy or stack.shape[3] < wx:
        raise ValueError("probe_sads: the plane is smaller than the window "
                         "of the offset set")
    dev = stack.device
    nj, nblk, kk = cand_y.shape
    active = _active_mask(active, (nj, nblk, kk, len(offsets)), dev)
    if not stack.is_cuda:
        return probe_sads_plain(stack, cand_y, cand_x, src_blocks, offsets,
                                bs_y, bs_x, pel, stats, active)
    name = "probe_sads[stats3]" if stats3 else "probe_sads"
    name = _launch_name(name, stack)
    if src_blocks.data_ptr() % 16:
        src_blocks = src_blocks.clone()     # the kernel reads 4-16 B words
    out, err = _launch_block(stack, cand_y, cand_x, src_blocks, offsets, bs_y,
                             bs_x, pel, active, stats3)
    cuda_build.check_launch(err, name)
    launches[name] += 1
    return out


def _launch_block(stack, cand_y, cand_x, src_blocks, offsets, bs_y: int,
                  bs_x: int, pel: int, active, stats3: bool):
    """(output, CUDA error) of a launch of the per-block probe (K4, or
    K4' with stats3)."""
    dev = stack.device
    offs, args = _probe_block_launch(offsets, bs_y, bs_x, pel,
                                     stack.dtype == torch.uint16, stack.shape,
                                     cand_y.shape, dev, stats3)
    out = torch.empty(cand_y.shape + (len(offsets),) + ((3,) if stats3
                                                        else ()),
                      dtype=I32, device=dev)
    err = _on_device(dev, _probe_block_fn(stats3), stack.data_ptr(),
                     cand_y.data_ptr(), cand_x.data_ptr(),
                     src_blocks.data_ptr(), offs.data_ptr(),
                     None if active is None else active.data_ptr(),
                     out.data_ptr(), args, _stream(dev))
    return out, err


# ---------------------------------------------------------------------------
# K2: tiled probe


def probe_sads_tiled_plain(stack, cand_y, cand_x, src_blocks, offsets,
                           bs_y: int, bs_x: int, pel: int, row_len: int,
                           tile: int, wy_total: int, wx_total: int,
                           center_y: int, center_x: int,
                           stats: str = "sad", active=None) -> torch.Tensor:
    """Plain PyTorch version of the tiled probe (same contract as the
    kernel, either form): per-candidate SADs (or stat triples) where the
    candidate window fits its tile's extent and the entry is active,
    INVALID_SAD (in all three) elsewhere."""
    global plain_calls_on_cuda
    if stack.is_cuda:
        plain_calls_on_cuda += 1
    stats3 = _check_stats("probe_sads_tiled", stats, stack)
    logp = pel.bit_length() - 1
    min_dx, min_dy, wy, _, _, cxs = _tile_geom(offsets, bs_y, bs_x, pel)
    nj, _, hp, wp = stack.shape
    _, nblk, kk = cand_y.shape
    nrows = nblk // row_len
    dev = stack.device
    wb_y = ((cand_y + min_dy) >> logp).reshape(nj, nrows, row_len, kk)
    wb_x = ((cand_x + min_dx) >> logp).reshape(nj, nrows, row_len, kk)
    # tile members, block rows edge-padded to a multiple of `tile`
    col = torch.arange(row_len, device=dev)
    c0 = (col // tile) * tile
    last = row_len - 1

    def member(wb, c):
        return wb[:, :, c.clamp(max=last), 0]               # [J, rows, len]

    ay = _tile_base(member(wb_y, c0), member(wb_y, c0 + tile // 2),
                    member(wb_y, c0 + tile - 1), center_y, hp - wy_total, ~7)
    ax = _tile_base(member(wb_x, c0), member(wb_x, c0 + tile // 2),
                    member(wb_x, c0 + tile - 1), center_x, wp - wx_total,
                    ~127)
    rel_y = wb_y - ay[..., None]
    rel_x = wb_x - ax[..., None]
    valid = ((rel_y >= 0) & (rel_y + wy <= wy_total) & (rel_x >= 0)
             & ((rel_x & ~127) + cxs <= wx_total)).reshape(nj, nblk, kk)
    src = pixels.widen(src_blocks)[:, :, None]              # [J, nblk, 1, ..]
    cols = []
    for dx, dy in offsets:
        ref = _gather_blocks_plain(stack, cand_y + dy, cand_x + dx, bs_y,
                                   bs_x, logp)
        cols.append(_block_costs(ref, src, stats3))
    out = torch.stack(cols, dim=3)
    keep = valid[..., None]
    if active is not None:
        keep = keep & active
    return _invalid_where(keep, out)


def _invalid_where(keep, out):
    """out with INVALID_SAD (in all three stats) where keep [J, nblk, K, D]
    is False."""
    keep = keep.reshape(keep.shape + (1,) * (out.ndim - keep.ndim))
    return torch.where(keep, out, INVALID_SAD).to(I32)


def _active_mask(active, shape, device):
    """A contiguous bool [J, nblk, K, D] copy of an `active` argument
    (anything that broadcasts to it), or None for "all"."""
    if active is None:
        return None
    if active.dtype != torch.bool:
        raise ValueError(f"active: need a bool tensor, got {active.dtype}")
    if active.device != device:
        raise ValueError(f"active: on {active.device}, expected {device}")
    if active.shape == shape and active.is_contiguous():
        return active
    return torch.broadcast_to(active, shape).contiguous()


def _probe_lib(stats3: bool):
    lib = cuda_build.load("probe")
    fn = lib.mvt_probe_sads_tiled_stats3 if stats3 else lib.mvt_probe_sads_tiled
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * (23 if stats3 else 26) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


# tiles of a block a lane of the three-stat tiled probe keeps in registers
PROBE3_TPL = (1, 2, 4)


def probe3_launch_geom(bs_y: int, bs_x: int, n_offsets: int) -> dict:
    """Launch geometry of the three-stat tiled probe (K2',
    csrc/probe.cu::probe_stats3_kernel) for a block size and offset count:
    `g` lanes an offset, each owning `tpl` of the block's 4x4 tiles, so a
    warp has 32 // g offset slots, which its `cpw` candidates share (cpw > 1
    where a candidate's offsets fill no more than half of them); tpl 0 is
    the generic body, whose 32 lanes stride over the tiles.  The block's
    tiles are g * tpl where tpl is not 0."""
    n = (bs_y // 4) * (bs_x // 4)
    if n & (n - 1) == 0 and n <= 32:
        g, tpl = n, 1
    elif n % 32 == 0 and n // 32 in PROBE3_TPL:
        g, tpl = 32, n // 32
    else:
        g, tpl = 32, 0
    cpw = 1
    while 2 * cpw * n_offsets <= 32 // g:
        cpw *= 2
    return dict(g=g, tpl=tpl, cpw=cpw)


# chunks of source words a lane of the uint16 tiled probe keeps in registers
PROBE16_CH = (1, 2, 4)


def probe16_chunks(bs_y: int, bs_x: int) -> tuple[int, int, int]:
    """(cw, ch, g) of the uint16 tiled probe (K2 u16,
    csrc/probe.cu::probe16_kernel<cw, ch>) for a block size: a block row of
    bs_x pixels is bs_x // 2 words, cut in chunks of `cw` words (the most of
    4, 2 and 1 that divide the row; one vector load each); an item's `g`
    lanes hold `ch` chunks each (two where the block has 2 to 64 chunks; ch
    0 is the generic body, whose 32 lanes stride over the chunks)."""
    wpr = bs_x // 2
    cw = next(c for c in (4, 2, 1) if wpr % c == 0)
    nc = bs_y * (wpr // cw)
    g = min(32, max(1, nc // 2))
    ch = nc // g
    if ch not in PROBE16_CH:
        g, ch = 32, 0
    return cw, ch, g


def probe16_launch_geom(bs_y: int, bs_x: int, kk: int, n_items: int,
                        in_flight: int) -> dict:
    """Launch geometry of the uint16 tiled probe for a block size, K
    candidates and n_items (job, block, candidate) items in all, on a card
    that keeps `in_flight` warps of the kernel resident
    (probe16_in_flight).

    cw, ch, g: probe16_chunks.  A CTA takes `span` blocks of a block row,
    up to 32 items a warp and two warps: a lane checks an item's flags and
    validity, then `g` lanes take each live, valid item.  A launch with
    fewer items than `in_flight` warps of 32 gives each warp fewer (down to
    4, one warp a CTA), so that the warps walking the live items' offsets
    fill the card."""
    cw, ch, g = probe16_chunks(bs_y, bs_x)
    per_warp, warps = 32, 2
    while per_warp > 4 and n_items < per_warp * in_flight:
        per_warp //= 2
    if per_warp < 32:
        warps = 1
    return dict(cw=cw, ch=ch, g=g, warps=warps,
                span=max(1, per_warp * warps // kk))


@functools.lru_cache(maxsize=None)
def probe16_in_flight(device: int, cw: int, ch: int) -> int:
    """Warps of csrc/probe.cu::probe16_kernel<cw, ch> that CUDA device
    `device` keeps resident: its SMs times the warps an SM keeps in CTAs of
    two warps, which the kernel's registers decide."""
    fn = cuda_build.load("probe").mvt_probe16_resident_warps
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        per_sm = fn(cw, ch, 2)
    cuda_build.check_launch(max(0, -per_sm), "probe_sads_tiled[u16]")
    return torch.cuda.get_device_properties(device).multi_processor_count \
        * per_sm


def probe_sads_tiled(stack, cand_y, cand_x, src_blocks, offsets,
                     bs_y: int, bs_x: int, pel: int, row_len: int,
                     pitch_x: int, tile: int = 0, margin_y: int = 20,
                     margin_x: int = 64, stats: str = "sad",
                     active=None) -> torch.Tensor:
    """[J, nblk, K, D] int32 SADs over a [nrows, row_len] block grid; with
    stats="sad_satd_luma" [J, nblk, K, D, 3] triples (SAD, SATD, sum of the
    reference block), an off-tile candidate reporting INVALID_SAD in all
    three.

    stack: [J, pel^2, Hp, Wp] uint8 or uint16 pad_stack output;
    cand_y/cand_x: [J, nblk, K] int32 candidate pel positions (see module
    doc); src_blocks: [J, nblk, bs_y, bs_x] of the stack's dtype; offsets:
    static [(dx, dy), ...] pel offsets evaluated per candidate; active:
    optional bool tensor that
    broadcasts to [J, nblk, K, D] (None: all): an inactive entry reads
    nothing and reports INVALID_SAD (in all three).  Block rows are treated
    as edge-padded to a multiple of `tile` (the kernel clamps member indices
    instead of materialising the padding).  A plane smaller than the tile
    window is served by probe_sads: every candidate is then valid, and it
    takes the mask as this kernel does."""
    offsets = _offset_set(offsets, bs_y, bs_x, pel)[0]
    nj, nblk, kk = cand_y.shape
    active = _active_mask(active, (nj, nblk, kk, len(offsets)), stack.device)
    if tile <= 0:
        tile = 8 if kk <= 2 else 4
    wy_total, wx_total, center_y, center_x = _tile_window(
        offsets, bs_y, bs_x, pel, tile, pitch_x, margin_y, margin_x)
    if (stack.shape[-2] < wy_total or stack.shape[-1] < wx_total
            or nblk % row_len != 0):
        return probe_sads(stack, cand_y, cand_x, src_blocks, offsets, bs_y,
                          bs_x, pel, stats, active)
    stats3 = _check_stats("probe_sads_tiled", stats, stack)
    _check_probe_args("probe_sads_tiled", stack, cand_y, cand_x, src_blocks,
                      bs_y, bs_x, pel, stats3)
    if not stack.is_cuda:
        return probe_sads_tiled_plain(
            stack, cand_y, cand_x, src_blocks, offsets, bs_y, bs_x, pel,
            row_len, tile, wy_total, wx_total, center_y, center_x, stats,
            active)

    dev = stack.device
    min_dx, min_dy, wy, _, _, cxs = _tile_geom(offsets, bs_y, bs_x, pel)
    offs = _offsets_tensor(offsets, dev)
    if src_blocks.data_ptr() % 16:
        src_blocks = src_blocks.clone()     # the kernels read 4-16 B words
    if active is not None and active.data_ptr() % 16:
        active = active.clone()             # and the flags as 32-bit words
    if stats3:
        name = "probe_sads_tiled[stats3]"
        g = probe3_launch_geom(bs_y, bs_x, len(offsets))
        geom = (g["g"], g["tpl"], g["cpw"])
    elif stack.dtype == torch.uint16:
        name = "probe_sads_tiled[u16]"
        cw, ch, _ = probe16_chunks(bs_y, bs_x)
        g = probe16_launch_geom(bs_y, bs_x, kk, nj * nblk * kk,
                                probe16_in_flight(dev.index, cw, ch))
        geom = (1, g["cw"], g["ch"], g["g"], g["warps"], g["span"])
    else:
        name = "probe_sads_tiled"
        geom = (0,) * 6
    out = torch.empty((nj, nblk, kk, len(offsets)) + ((3,) if stats3 else ()),
                      dtype=I32, device=dev)
    with torch.cuda.device(dev):
        err = _probe_lib(stats3)(
            stack.data_ptr(), cand_y.data_ptr(), cand_x.data_ptr(),
            src_blocks.data_ptr(), offs.data_ptr(),
            0 if active is None else active.data_ptr(), out.data_ptr(),
            nj, pel * pel, stack.shape[2], stack.shape[3], nblk, row_len,
            kk, len(offsets), tile, bs_y, bs_x, pel.bit_length() - 1,
            min_dy, min_dx, wy, cxs, wy_total, wx_total, center_y, center_x,
            *geom, torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, name)
    launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# K3: tiled block fetch


def fetch_blocks_tiled_plain(stack, cand_y, cand_x, bs_y: int, bs_x: int,
                             pel: int) -> torch.Tensor:
    """Plain PyTorch version of the tiled block fetch (same contract as the
    kernel): the full-pel origin is taken into the plane as a whole
    (wrap_clamp), as fetch_blocks_plain takes it."""
    global plain_calls_on_cuda
    if stack.is_cuda:
        plain_calls_on_cuda += 1
    return _fetch_window_plain(stack, cand_y, cand_x, bs_y, bs_x, pel)


def _fetch_window_plain(stack, cand_y, cand_x, bs_y: int, bs_x: int,
                        pel: int) -> torch.Tensor:
    """The fetches' function: [..., bs_y, bs_x] windows of the subplane of
    each candidate's parity, the full-pel origin wrapped once and clamped
    into [0, Hp - bs_y] x [0, Wp - bs_x] (wrap_clamp)."""
    logp = pel.bit_length() - 1
    pelm = pel - 1
    hp, wp = stack.shape[-2:]
    sub = (cand_x & pelm) | ((cand_y & pelm) << logp)
    return _gather_at(stack, sub, wrap_clamp(cand_y >> logp, hp, bs_y),
                      wrap_clamp(cand_x >> logp, wp, bs_x), bs_y, bs_x)


# block widths the fetch kernel (csrc/fetch.cu) has a body of its own for
FETCH_WIDTHS = (4, 8, 16, 32)


def fetch_launch_geom(bs_y: int, bs_x: int) -> dict:
    """Launch geometry of the fetch kernel: `bsx_t`, the template width (0:
    the generic body), 2**log_t lanes per candidate, the fewest powers of
    two that cover the block's int4 groups (its pixels in the generic body
    without int4 stores), at most a warp, so that a warp still writes 512
    contiguous bytes a step."""
    units = bs_y * bs_x // 4 if bs_x % 4 == 0 else bs_y * bs_x
    log_t = 0
    while (1 << log_t) < units and log_t < 5:
        log_t += 1
    return dict(bsx_t=bs_x if bs_x in FETCH_WIDTHS else 0, log_t=log_t)


def _fetch_lib():
    fn = cuda_build.load("fetch").mvt_fetch_blocks
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_fetch_args(what, stack, cand_y, cand_x, pel):
    dev = stack.device
    _check(stack, "stack", pixels.PIXEL_DTYPES, 4)
    _check(cand_y, "cand_y", I32, 3, dev)
    _check(cand_x, "cand_x", I32, 3, dev)
    if (cand_x.shape != cand_y.shape or stack.shape[0] != cand_y.shape[0]
            or stack.shape[1] != pel * pel):
        raise ValueError(f"{what}: inconsistent shapes")


def _launch_fetch(what, stack, cand_y, cand_x, bs_y, bs_x, pel):
    _check_fetch_args(what, stack, cand_y, cand_x, pel)
    dev = stack.device
    nj, nblk, kk = cand_y.shape
    out = torch.empty((nj, nblk, kk, bs_y, bs_x), dtype=I32, device=dev)
    g = fetch_launch_geom(bs_y, bs_x)
    with torch.cuda.device(dev):
        err = _fetch_lib()(
            stack.data_ptr(), cand_y.data_ptr(), cand_x.data_ptr(),
            out.data_ptr(), nj, pel * pel, stack.shape[2], stack.shape[3],
            nblk, kk, bs_y, bs_x, pel.bit_length() - 1, g["bsx_t"],
            g["log_t"], int(what == "fetch_blocks_tiled"),
            int(stack.dtype == torch.uint16),
            torch.cuda.current_stream().cuda_stream)
    name = _launch_name(what, stack)
    cuda_build.check_launch(err, name)
    launches[name] += 1
    return out


FETCH_TILE = 8   # blocks per tile of the tiled fetch's window


def fetch_blocks_tiled(stack, cand_y, cand_x, bs_y: int, bs_x: int,
                       pel: int, row_len: int, pitch_x: int) -> torch.Tensor:
    """[J, nblk, K, bs_y, bs_x] int32 reference blocks over a
    [nrows, row_len] block grid whose blocks lie pitch_x full pels apart.

    stack: [J, pel^2, Hp, Wp] uint8 or uint16; cand_y/cand_x: [J, nblk, K]
    int32 pel positions of the block origin in the stack.  Exact for every
    block; the full-pel origin is taken into the plane as a whole
    (wrap_clamp), as the JAX package's CPU path takes it.  A stack under the
    tile window (tile_params of one block, FETCH_TILE blocks wide) or a grid
    that is not whole rows goes to fetch_blocks, as the JAX package hands it
    to its per-block fetch kernel."""
    wy_total, wx_total, _, _ = tile_params(((0, 0),), bs_y, bs_x, pel,
                                           FETCH_TILE, pitch_x)
    if (stack.shape[-2] < wy_total or stack.shape[-1] < wx_total
            or cand_y.shape[1] % row_len != 0):
        return fetch_blocks(stack, cand_y, cand_x, bs_y, bs_x, pel)
    if not stack.is_cuda:
        return fetch_blocks_tiled_plain(stack, cand_y, cand_x, bs_y, bs_x,
                                        pel)
    return _launch_fetch("fetch_blocks_tiled", stack, cand_y, cand_x, bs_y,
                         bs_x, pel)


# ---------------------------------------------------------------------------
# K5: per-block fetch


def fetch_blocks_plain(stack, cand_y, cand_x, bs_y: int,
                       bs_x: int, pel: int) -> torch.Tensor:
    """Plain PyTorch version of the per-block fetch (same contract as the
    kernel): the full-pel origin is taken AS A WHOLE the way a window slice
    takes an out-of-range start (wrap_clamp: into [0, Hp - bs_y] x
    [0, Wp - bs_x]), so a block is always a bs_y x bs_x window of the
    plane."""
    global plain_calls_on_cuda
    if stack.is_cuda:
        plain_calls_on_cuda += 1
    return _fetch_window_plain(stack, cand_y, cand_x, bs_y, bs_x, pel)


def fetch_blocks(stack, cand_y, cand_x, bs_y: int, bs_x: int,
                 pel: int) -> torch.Tensor:
    """[J, nblk, K, bs_y, bs_x] int32 reference blocks, one per
    (job, block, candidate).

    stack: [J, pel^2, Hp, Wp] uint8 or uint16 pad_stack output;
    cand_y/cand_x: [J, nblk, K] int32 candidate pel positions of the block
    origin (see module doc).  Subplane (cx & (pel-1)) | ((cy & (pel-1)) <<
    logp); the full-pel origin is taken into the plane as a whole
    (wrap_clamp).  The kernel serves every call on CUDA tensors, however
    few the blocks."""
    if stack.shape[-2] < bs_y or stack.shape[-1] < bs_x:
        raise ValueError("fetch_blocks: the plane is smaller than a block")
    if not stack.is_cuda:
        return fetch_blocks_plain(stack, cand_y, cand_x, bs_y, bs_x, pel)
    return _launch_fetch("fetch_blocks", stack, cand_y, cand_x, bs_y, bs_x,
                         pel)
