"""Reference-compatible binary serialisation of MV fields and metadata.

The reference transports vectors between filters as two binary frame props:
`MVTools_MVAnalysisData` (the 26-int MVAnalysisData struct,
MVAnalysisData.h:81-134) and `MVTools_vectors`
([totalSize, validity, per level coarsest->finest: size, nBlkCount x
VECTOR{int32 x, int32 y, int64 sad}], GroupOfPlanes.c:77-108,
PlaneOfBlocks.cpp:413-416).  This codec reproduces those byte layouts
exactly (little-endian, VECTOR padded to 16 bytes by the int64 member), the
same bytes as the JAX package's codec, so fields interoperate with
reference-produced data and serve as a checkpointable intermediate.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..convert import require_device
from .types import AnalysisMeta, MVField, MVPlaneField

# C layout: int x(0), int y(4), [4 bytes padding], int64 sad(8) -> 16 bytes
VECTOR_DTYPE = np.dtype({"names": ["x", "y", "sad"],
                         "formats": ["<i4", "<i4", "<i8"],
                         "offsets": [0, 4, 8],
                         "itemsize": 16})


def encode_analysis_meta(meta: AnalysisMeta) -> bytes:
    """Serialise AnalysisMeta with the MVAnalysisData field order
    (MVAnalysisData.h:81-134); 21 int32s."""
    values = [
        meta.magic_key, meta.version, meta.blk_size_x, meta.blk_size_y,
        meta.pel, meta.lv_count, meta.delta_frame, int(meta.is_backward),
        0,  # nCPUFlags — meaningless off-CPU; kept for layout parity
        meta.motion_flags, meta.width, meta.height, meta.overlap_x,
        meta.overlap_y, meta.blk_x, meta.blk_y, meta.bits_per_sample,
        meta.y_ratio_uv, meta.x_ratio_uv, meta.hpadding, meta.vpadding,
    ]
    return struct.pack("<21i", *values)


def decode_analysis_meta(data: bytes) -> AnalysisMeta:
    v = struct.unpack("<21i", data)
    return AnalysisMeta(
        magic_key=v[0], version=v[1], blk_size_x=v[2], blk_size_y=v[3],
        pel=v[4], lv_count=v[5], delta_frame=v[6], is_backward=bool(v[7]),
        motion_flags=v[9], width=v[10], height=v[11], overlap_x=v[12],
        overlap_y=v[13], blk_x=v[14], blk_y=v[15], bits_per_sample=v[16],
        y_ratio_uv=v[17], x_ratio_uv=v[18], hpadding=v[19], vpadding=v[20])


def encode_mv_field(mv: MVField) -> bytes:
    """Serialise one field (no job axis) to the MVTools_vectors layout
    (coarsest level first; a divided field's sub-block level goes last)."""
    chunks = []
    total = 8
    # levels are stored finest-first in MVField; the blob wants coarsest
    # first, with the divided level (index 0 of a divided field) last
    for lv in reversed(mv.levels):
        nblk = lv.x.numel()
        size = 4 + nblk * 16
        arr = np.zeros(nblk, VECTOR_DTYPE)
        arr["x"] = lv.x.reshape(-1).cpu().numpy()
        arr["y"] = lv.y.reshape(-1).cpu().numpy()
        arr["sad"] = lv.sad.reshape(-1).cpu().numpy()
        chunks.append(struct.pack("<i", size) + arr.tobytes())
        total += size
    validity = int(mv.validity)
    return struct.pack("<ii", total, validity) + b"".join(chunks)


def decode_mv_field(data: bytes, meta: AnalysisMeta, divided: int = 0,
                    device="cuda") -> MVField:
    """Parse an MVTools_vectors blob (fgopUpdate Fakery.c:110-121) into a
    field on `device`."""
    dev = require_device(device)
    total, validity = struct.unpack_from("<ii", data, 0)
    if total != len(data):
        raise ValueError(f"MV blob size mismatch: header {total}, "
                         f"got {len(data)}")
    offset = 8
    level_shapes = [(nby, nbx) for (nbx, nby) in meta.level_blocks()]
    if divided:
        level_shapes.insert(0, (meta.blk_y * 2, meta.blk_x * 2))
    levels = []
    ordered = list(reversed(level_shapes))     # blob is coarsest-first
    for li, (nby, nbx) in enumerate(ordered):
        if divided and li == len(ordered) - 1:
            # the divided sub-block chunk's size slot is never written
            # by the reference's searched path (gopExtraDivide writes
            # only the vectors, GroupOfPlanes.c:206-302) nor read by
            # Fakery (fgopUpdate advances past it last, Fakery.c:
            # 110-121): compute the size, ignore the stored bytes
            size = 4 + nbx * nby * 16
        else:
            (size,) = struct.unpack_from("<i", data, offset)
        nblk = (size - 4) // 16
        if nblk != nbx * nby:
            raise ValueError(
                f"MV blob level size mismatch: {nblk} != {nbx * nby}")
        arr = np.frombuffer(data, VECTOR_DTYPE, count=nblk, offset=offset + 4)
        levels.append(MVPlaneField(*(
            torch.from_numpy(np.ascontiguousarray(arr[k]).reshape(nby, nbx))
            .to(dev) for k in ("x", "y", "sad"))))
        offset += size
    levels.reverse()  # back to finest-first
    return MVField(tuple(levels),
                   torch.tensor(validity, dtype=torch.int32, device=dev),
                   meta)
