"""PyTorch port: the whole slice — the batched denoise function of
models/denoise.py (Super -> batched lockstep Analyse -> Degrain1) —
against the same composition on the JAX side (build_super per frame ->
analyse_batch -> degrain per output frame), bit for bit; plus the port's
import hygiene.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the pipeline is integer)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mvtools_tpu_torch.degrain import DegrainConfig
from mvtools_tpu_torch.models.denoise import (degrain_window, headline_specs,
                                              make_test_clip)

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load(tmp_path_factory)


def test_degrain_window_matches_jax(ref):
    sspec, aspec = tpr.specs(ref)
    info = {}
    out = degrain_window(torch.from_numpy(ref["frames"]), sspec, aspec,
                         DegrainConfig(thsad=400), tpr.RADIUS, info)
    assert out.shape == (tpr.N_FRAMES - 2 * tpr.RADIUS, tpr.H, tpr.W)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref["degrain"])
    for lv in range(tpr.LEVELS):
        np.testing.assert_array_equal(info["fields"].levels[lv].x.numpy(),
                                      ref[f"mv_x{lv}"])


def test_headline_specs_are_the_shared_geometry(ref):
    sspec, aspec = tpr.specs(ref)
    mine_s, mine_a, dcfg = headline_specs(tpr.W, tpr.H, tpr.BLK, tpr.LEVELS)
    assert (mine_s, mine_a) == (sspec, aspec)
    assert dcfg == DegrainConfig(thsad=400)
    full_s, full_a, _ = headline_specs()
    assert (full_a.meta.blk_x, full_a.meta.blk_y) == (120, 67)
    assert full_a.badsad == 40000


def test_test_clip_recipe():
    """make_test_clip is the numpy recipe of the shared reference clip."""
    clip = make_test_clip(4, tpr.W, tpr.H, seed=tpr.SEED, flash=tpr.FLASH,
                          device="cpu")
    np.testing.assert_array_equal(clip.numpy(), tpr.make_frames())
    plain = make_test_clip(2, 64, 48, seed=1, device="cpu").numpy()
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (48 + 32, 64 + 32), np.uint8)
    np.testing.assert_array_equal(plain[1], base[2:50, 3:67])


def test_window_too_short_raises():
    sspec, aspec, dcfg = headline_specs(tpr.W, tpr.H)
    with pytest.raises(ValueError, match="window"):
        degrain_window(torch.zeros((2, tpr.H, tpr.W), dtype=torch.uint8),
                       sspec, aspec, dcfg)


def _port_sources():
    for base, _, files in os.walk(os.path.join(ROOT, "mvtools_tpu_torch")):
        if os.path.basename(base) in ("build", "__pycache__"):
            continue
        for f in files:
            if f.endswith((".py", ".cu")):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_nothing_of_jax():
    pat = re.compile(r"import jax|from jax|mvtools_tpu(\.|\s|$)|"
                     r"torch\.compile|import triton")
    hits = []
    for path in _port_sources():
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                if pat.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{n}: "
                                f"{line.strip()}")
    assert not hits, "\n".join(hits)


def test_port_imports_without_jax_installed():
    """`import mvtools_tpu_torch` works in an interpreter where jax and
    triton cannot be imported."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['triton'] = None; "
            "import mvtools_tpu_torch, mvtools_tpu_torch.convert, "
            "mvtools_tpu_torch.models.denoise, mvtools_tpu_torch.ops.sadmap; "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m, v in sys.modules.items() if v is not None)")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_kernel_wrappers_dispatch_on_the_tensor_device_alone():
    """On a CUDA tensor a wrapper launches its kernel or raises — it never
    takes the plain version: the only dispatch is on `is_cuda`, and no
    wrapper catches an error."""
    import inspect
    from mvtools_tpu_torch.ops import probe, sadmap
    for fn in (sadmap.sad_map, probe.probe_sads_tiled,
               probe.fetch_blocks_tiled):
        src = inspect.getsource(fn)
        assert "if not stack.is_cuda:" in src
        assert "try:" not in src and "except" not in src
