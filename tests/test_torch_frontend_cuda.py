"""The front end on the card: the streamed export of a CUDA frame against
the serial export of the same pixels, and the nodes on the card.

Every test needs an NVIDIA GPU and skips without one.  The card's host has
no JAX, so run this file there without the suite's conftest:

    python -m pytest -m cuda tests/test_torch_frontend_cuda.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from hdrvae_torch.api import nodes
from hdrvae_torch.api.vae import VAE
from hdrvae_torch.core.config import (DecoderConfig, ExportConfig,
                                      HDRDecodeConfig, Precision,
                                      UpscaleConfig)
from hdrvae_torch.decode.pipeline import hdr_decode
from hdrvae_torch.io import pipeline
from hdrvae_torch.io.export import export_linear
from hdrvae_torch.kernels import attention, conv3x3
from hdrvae_torch.models.rrdbnet import RRDBNetConfig, init_rrdbnet
from hdrvae_torch.upscale.pipeline import hdr_upscale

pytestmark = pytest.mark.cuda

# a narrow decoder the kernels take (widths 64 / 128, 32 groups)
NARROW = DecoderConfig(z_channels=4, ch=64, ch_mult=(1, 2), num_res_blocks=1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m "
                    "pytest -m cuda tests/test_torch_frontend_cuda.py "
                    "--noconftest")
    return torch.device("cuda")


def _frame():
    """HDR values, negatives, -0, float16 subnormals and overflow, +-inf,
    and NaNs with assorted payloads and signs."""
    r = np.random.default_rng(0)
    img = (r.standard_normal((67, 45, 3)) * 4).astype(np.float32)
    specials = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FBFFFFF,
                         0x7FC02000, 0xFF812345, 0x7F800000, 0xFF800000,
                         0x80000000, 0x33800000, 0x387FC000, 0x477FF000,
                         0x477FF001, 0x47800000], np.uint32).view(np.float32)
    img.reshape(-1)[:specials.size] = specials
    return img


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[n] = f.read()
    return out


@pytest.mark.parametrize("compression", ["none", "rle", "zip", "piz",
                                         "pxr24"])
@pytest.mark.parametrize("bit_depth", ["16bit", "32bit"])
def test_streamed_cuda_frame_matches_serial(dev, tmp_path, compression,
                                            bit_depth):
    """export_frame_streamed and export_stream of CUDA frames (the float16
    cast on the card for 16-bit output) write the serial exporter's bytes
    of the same pixels on the host."""
    img = _frame()
    cfg = ExportConfig(filename_prefix="f", output_path="",
                       bit_depth=bit_depth, compression=compression)
    ref = export_linear(img, cfg, default_output_dir=str(tmp_path / "s"))
    assert ref.error is None
    want = _files(tmp_path / "s")
    frame = torch.from_numpy(img).to(dev)
    for band in (1, 16, 256):
        d = tmp_path / f"b{band}"
        res = pipeline.export_frame_streamed(frame, cfg, band_rows=band,
                                             default_output_dir=str(d))
        assert res.error is None, res.error
        assert _files(d) == want, band
    res = pipeline.export_stream([frame, lambda: frame.clone()], ExportConfig(
        filename_prefix="q", output_path="", bit_depth=bit_depth,
        compression=compression, frame_sequence=True),
        default_output_dir=str(tmp_path / "q"), fetch_workers=3)
    assert res.error is None and len(res.filepaths) == 2
    ser = export_linear(np.stack([img, img]), ExportConfig(
        filename_prefix="q", output_path="", bit_depth=bit_depth,
        compression=compression, frame_sequence=True),
        default_output_dir=str(tmp_path / "qs"))
    assert ser.error is None
    assert _files(tmp_path / "q") == _files(tmp_path / "qs")


def test_fetch_waits_on_its_frame_only(dev):
    """The copy stream waits on the cast's event alone: a long kernel
    queued behind the frame on the same stream is still running when the
    fetch returns."""
    frame = torch.randn(512, 512, 3, device=dev)
    pipeline._fetch(frame, True, 2)   # the pinned allocator warmed up
    staged = pipeline._stage(frame, True)
    a = torch.randn(4096, 4096, device=dev)
    for _ in range(20):     # ~tens of ms of work behind the frame
        a = a @ a
        a = a / a.norm()
    host = pipeline._fetch(staged, True, 2)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(host, frame.half().cpu().numpy())
    assert busy, "the fetch waited for the work queued behind its frame"


def test_nodes_on_the_card(dev, tmp_path, monkeypatch):
    """HDRVAEDecode in the fast tier (the K1 / K2 / K3 chain) equals the
    direct decode; HDRUpscaleWithModel loads onto the card and equals
    hdr_upscale; LinearEXRExport writes the image; IMAGE outputs are float32
    CPU tensors."""
    vae = VAE.random_init(0, NARROW, Precision.fast(), device=dev)
    z = np.random.default_rng(1).standard_normal((1, 16, 24, 4)).astype(
        np.float32)
    k1 = conv3x3.fused_conv3x3.launches
    k3 = attention.flash_attention_bf16.launches
    (image,) = nodes.HDRVAEDecode().simple_hdr_decode(
        {"samples": torch.from_numpy(z).permute(0, 3, 1, 2)}, vae)
    assert conv3x3.fused_conv3x3.launches > k1
    assert attention.flash_attention_bf16.launches > k3
    assert image.device.type == "cpu" and image.dtype == torch.float32
    direct = hdr_decode(vae.decoder, torch.from_numpy(z).to(dev),
                        HDRDecodeConfig(), vae.precision).image.cpu()
    torch.testing.assert_close(image, direct, rtol=0, atol=0)
    (std,) = nodes.VAEDecode().decode({"samples": z}, vae)
    assert std.device.type == "cpu" and std.shape == image.shape
    mdir = tmp_path / "models" / "upscale_models"
    mdir.mkdir(parents=True)
    net = init_rrdbnet(RRDBNetConfig().with_small(), seed=3, device="cpu")
    torch.save(net.state_dict(), str(mdir / "tiny.pth"))
    monkeypatch.setenv("HDRVAE_MODELS_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path / "out"))
    (up,) = nodes.HDRUpscaleWithModel().upscale(image, "tiny.pth", False,
                                                False, "bislerp")
    (key, (model, _, arch)), = nodes.HDRUpscaleWithModel._MODEL_CACHE.items()
    assert next(model.parameters()).device.type == "cuda"
    ref = hdr_upscale(model, image.to(dev), UpscaleConfig(),
                      architecture=arch).image.cpu()
    torch.testing.assert_close(up, ref, rtol=0, atol=0)
    (path,) = nodes.LinearEXRExport().export_linear_exr(
        up, filename_prefix="card", output_path="", bit_depth="32bit")
    from hdrvae_torch.io.exr import read_exr
    np.testing.assert_array_equal(read_exr(path), up[0].numpy())
    nodes.HDRUpscaleWithModel._MODEL_CACHE.clear()
