"""PyTorch port: the stabilisation chain, the MV blob codec, y4m I/O,
DegrainPipeline and the command line against the JAX package on the CPU.

* models.stabilize.stabilize_clip end to end: the motions come from the
  FFT estimate (tolerances of tests/test_torch_depan_estimate.py), so a
  source coordinate can land on the other side of a rounding step where a
  motion differs in its last bits: at most PIXEL_SHARE of the pixels may
  differ (measured: none on these clips).
* core/codec.py: the same bytes as the JAX codec for the same field
  (tolerance 0), and back.
* io/: the port's own binding to native/y4m.cc writes the same file as the
  JAX package's binding and reads it back.
* pipelines.DegrainPipeline: bit for bit against the JAX one.
* `python -m mvtools_tpu_torch.cli --device cpu` against
  `tools/mvtools_run.py --cpu` (64x48 YUV420, 6 frames, --levels 1
  --pel 1): degrain3 byte for byte; stabilise within PIXEL_SHARE, as
  stabilize_clip.  degrain3 runs on the exact engine: the JAX command
  line's jit of the lockstep engine at radius 3 took 195 s to compile on
  this box with a cold cache, the exact engine's 24 s (the port's 4 s
  either way, one thread); the lockstep degrain_n_frame is held to the
  JAX package by tests/test_torch_degrain_frame.py."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mvtools_tpu.core import codec as jcodec
from mvtools_tpu.core.types import MVField as JField
from mvtools_tpu.core.types import MVPlaneField as JPlane
from mvtools_tpu import depan as jd
from mvtools_tpu.io import Y4MReader as JReader
from mvtools_tpu.io import Y4MWriter as JWriter
from mvtools_tpu.models.stabilize import stabilize_clip as jstabilize
from mvtools_tpu_torch import depan as td
from mvtools_tpu_torch.core import codec
from mvtools_tpu_torch.core.types import MVField, MVPlaneField
from mvtools_tpu_torch.io import Y4MReader, Y4MWriter, read_clip, write_clip
from mvtools_tpu_torch.models.stabilize import stabilize_clip

import torch_flow_cases as tfc
from test_torch_depan_estimate import pan_clip

PIXEL_SHARE = 0.005


def _yuv_frames(seed, n, w, h):
    """[Y, U, V] numpy frames: the luma a panned texture (trust far above
    the limit), the chroma planes its decimations."""
    luma = pan_clip(seed, n, w, h, cut=n - 2, step=2.0)
    return [[y, y[::2, ::2] // 2 + 40, y[1::2, 1::2] // 2 + 60]
            for y in luma]


def _share_differing(got, want):
    diff = [np.asarray(g) != np.asarray(w) for g, w in zip(got, want)]
    return sum(int(d.sum()) for d in diff) / sum(d.size for d in diff)


def test_stabilize_clip_matches_jax():
    """Estimate + stabilise, method 0 and method 1 with prev/next filling,
    mirrors and bicubic, on a 96x64 YUV420 clip with a scene cut."""
    frames = _yuv_frames(3, 6, 96, 64)
    for kw in (dict(), dict(method=1, prev=1, next=1, mirror=15)):
        info = {}
        got = stabilize_clip([[torch.from_numpy(p) for p in f]
                              for f in frames], td.DepanEstimateConfig(),
                             td.DepanStabiliseConfig(**kw), 1, 1, info=info)
        want = jstabilize([[jnp.asarray(p) for p in f] for f in frames],
                          jd.DepanEstimateConfig(),
                          jd.DepanStabiliseConfig(**kw), 1, 1)
        assert info["motions"].shape == (6, 4)
        assert (info["motions"][1:4, 0] != 0).all()      # trusted pans
        flat_g = [p for f in got for p in f]
        flat_w = [p for f in want for p in f]
        assert [tuple(p.shape) for p in flat_g] == \
            [tuple(np.asarray(p).shape) for p in flat_w]
        assert _share_differing(flat_g, flat_w) <= PIXEL_SHARE, kw


def _levels(rng, meta, divided):
    shapes = [(nby, nbx) for nbx, nby in meta.level_blocks()]
    if divided:
        shapes.insert(0, (meta.blk_y * 2, meta.blk_x * 2))
    return [(rng.integers(-64, 64, s).astype(np.int32),
             rng.integers(-64, 64, s).astype(np.int32),
             rng.integers(0, 1 << 40, s).astype(np.int64)) for s in shapes]


def test_codec_bytes_match_jax():
    """Fields of every level of a 4-level pyramid, plain and divided, valid
    and invalid: the blob and the meta blob are the JAX codec's bytes, and
    decode back to the same arrays (and to the port's types)."""
    _, aspec, _, _ = tfc.specs(128, 96, pel=2, blksize=8, overlap=4)
    rng = np.random.default_rng(5)
    meta, tmeta = tfc.meta_pair(aspec, True)
    assert codec.encode_analysis_meta(tmeta) == \
        jcodec.encode_analysis_meta(meta)
    assert codec.decode_analysis_meta(codec.encode_analysis_meta(tmeta)) \
        == tmeta
    assert meta.lv_count > 2
    for divided, validity in ((0, 1), (1, 0)):
        levels = _levels(rng, meta, divided)
        jf = JField(tuple(JPlane(*(jnp.asarray(a) for a in lv))
                          for lv in levels), jnp.asarray(validity, jnp.int32),
                    meta)
        tf = MVField(tuple(MVPlaneField(*(torch.from_numpy(a) for a in lv))
                           for lv in levels),
                     torch.tensor(validity, dtype=torch.int32), tmeta)
        blob = codec.encode_mv_field(tf)
        assert blob == jcodec.encode_mv_field(jf)
        back = codec.decode_mv_field(blob, tmeta, divided, device="cpu")
        assert int(back.validity) == validity
        assert len(back.levels) == len(levels)
        for lv, (x, y, sad) in zip(back.levels, levels):
            np.testing.assert_array_equal(lv.x.numpy(), x)
            np.testing.assert_array_equal(lv.y.numpy(), y)
            np.testing.assert_array_equal(lv.sad.numpy(), sad)
    with pytest.raises(ValueError):
        codec.decode_mv_field(blob[:-16], tmeta, 1, device="cpu")


def test_y4m_round_trip_and_jax_bytes(tmp_path):
    """The port's writer makes the JAX writer's file, byte for byte, at 8
    bits 4:2:0, 10 bits 4:2:2 and 16-bit gray; its reader gives the frames
    back, and takes tensors as well as arrays."""
    rng = np.random.default_rng(1)
    for bits, planes, sub in ((8, 3, (2, 2)), (10, 3, (2, 1)),
                              (16, 1, (1, 1))):
        dt = np.uint8 if bits <= 8 else np.uint16
        frames = [[rng.integers(0, 1 << bits, (48, 64), dt)]
                  + [rng.integers(0, 1 << bits, (48 // sub[1], 64 // sub[0]),
                                  dt) for _ in range(planes - 1)]
                  for _ in range(3)]
        ours, theirs = tmp_path / f"p{bits}.y4m", tmp_path / f"j{bits}.y4m"
        with Y4MWriter(str(ours), 64, 48, (24, 1), *sub, bits, planes) as wr:
            for k, f in enumerate(frames):
                wr.write([torch.from_numpy(p) for p in f] if k else f)
        with JWriter(str(theirs), 64, 48, (24, 1), *sub, bits, planes) as wr:
            for f in frames:
                wr.write(f)
        assert ours.read_bytes() == theirs.read_bytes()
        with Y4MReader(str(ours)) as rd:
            assert (rd.width, rd.height, rd.bits, rd.planes) == \
                (64, 48, bits, planes)
            got = list(rd)
        assert len(got) == 3
        for f, g in zip(frames, got):
            for a, b in zip(f, g):
                np.testing.assert_array_equal(a, b)
        with Y4MWriter(str(tmp_path / "bad.y4m"), 64, 48, (24, 1), *sub,
                       bits, planes) as bad, pytest.raises(ValueError):
            bad.write([frames[0][0][:-2]] + frames[0][1:])
    write_clip(str(tmp_path / "c.y4m"),
               [np.stack([f[0] for f in frames])], fps=(30, 1), bits=16)
    planes_back, info = read_clip(str(tmp_path / "c.y4m"))
    assert info.fps_num == 30 and planes_back[0].shape == (3, 48, 64)


def test_degrain_pipeline_matches_jax():
    """DegrainPipeline.run_clip (radius 2, the exact engine) gives the JAX
    pipeline's frames bit for bit."""
    from mvtools_tpu.core.config import AnalyseConfig as JA
    from mvtools_tpu.core.config import SuperConfig as JS
    from mvtools_tpu.core.types import ColorFamily as JC
    from mvtools_tpu.core.types import VideoFormat as JV
    from mvtools_tpu.degrain import DegrainConfig as JD
    from mvtools_tpu.pipelines import DegrainPipeline as JPipe
    from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig
    from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
    from mvtools_tpu_torch.degrain import DegrainConfig
    from mvtools_tpu_torch.pipelines import DegrainPipeline

    rng = np.random.default_rng(0)
    h, w = 32, 48
    base = rng.integers(40, 200, (h, w), np.int32)
    clip = np.clip(base[None] + rng.normal(0, 8, (5, h, w)), 0,
                   255).astype(np.uint8)
    kw = (dict(pel=1, levels=2, chroma=False),
          dict(blksize=8, levels=2, truemotion=True, chroma=False),
          dict(thsad=2000, thscd1=3000))
    want = JPipe(JV(w, h, 8, JC.GRAY), JS(**kw[0]), JA(**kw[1]),
                 JD(**kw[2]), radius=2, engine="exact").run_clip(
        [[jnp.asarray(f)] for f in clip])
    got = DegrainPipeline(VideoFormat(w, h, 8, ColorFamily.GRAY),
                          SuperConfig(**kw[0]), AnalyseConfig(**kw[1]),
                          DegrainConfig(**kw[2]), radius=2,
                          engine="exact").run_clip(
        [[torch.from_numpy(f)] for f in clip])
    assert len(got) == len(want) == 5
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(wnt[0]))


@pytest.fixture(scope="module")
def cli_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "in.y4m")
    with Y4MWriter(path, 64, 48, (30, 1), 2, 2, 8, 3) as wr:
        for f in _yuv_frames(4, 6, 64, 48):
            wr.write(f)
    return path


def _run(cmd):
    # one intra-op thread: the test runs beside other test processes
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stderr


@pytest.mark.parametrize("pipe", ["degrain3", "stabilise"])
def test_cli_matches_jax_cli(cli_clip, tmp_path, pipe):
    """The port's command line on the CPU against tools/mvtools_run.py:
    degrain3 byte for byte, stabilise within PIXEL_SHARE; both print the
    summary line."""
    flags = ["--levels", "1", "--pel", "1"]
    if pipe == "degrain3":
        flags += ["--engine", "exact"]
    ours, theirs = str(tmp_path / "port.y4m"), str(tmp_path / "jax.y4m")
    err = _run([sys.executable, "-m", "mvtools_tpu_torch.cli", pipe,
                cli_clip, ours, "--device", "cpu", *flags])
    assert err.strip().splitlines()[-1].startswith(f"{pipe}: 6 frames in ")
    _run([sys.executable, os.path.join(REPO, "tools", "mvtools_run.py"),
          pipe, cli_clip, theirs, "--cpu", *flags])
    with Y4MReader(ours) as a, JReader(theirs) as b:
        assert (a.width, a.height, a.planes) == (b.width, b.height,
                                                 b.planes)
        got, want = list(a), list(b)
    assert len(got) == len(want) == 6
    flat_g = [p for f in got for p in f]
    flat_w = [p for f in want for p in f]
    if pipe == "degrain3":
        for g, wnt in zip(flat_g, flat_w):
            np.testing.assert_array_equal(g, wnt)
    else:
        assert _share_differing(flat_g, flat_w) <= PIXEL_SHARE
