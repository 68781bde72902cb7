"""The port's entry points run on the card unless the caller asks for the
CPU: every loader and initializer defaults to ``device="cuda"``, and
without a card a call that does not name a device raises instead of
returning CPU tensors."""

import inspect

import pytest
import torch

from hdrvae_torch.core.config import DecoderConfig
from hdrvae_torch.models import hat, params, rrdbnet, swin2sr, swinir, zoo

ENTRY_POINTS = {
    "load_upscale_model": zoo.load_upscale_model,
    "decoder_from_state_dict": params.decoder_from_state_dict,
    "init_decoder": params.init_decoder,
    "init_rrdbnet": rrdbnet.init_rrdbnet,
    "rrdbnet_from_state_dict": rrdbnet.rrdbnet_from_state_dict,
    "init_swinir": swinir.init_swinir,
    "swinir_from_state_dict": swinir.swinir_from_state_dict,
    "init_hat": hat.init_hat,
    "hat_from_state_dict": hat.hat_from_state_dict,
    "init_swin2sr": swin2sr.init_swin2sr,
    "swin2sr_from_state_dict": swin2sr.swin2sr_from_state_dict,
}


def _call_without_device(name, tmp_path):
    """Call the entry point with small valid arguments and no device."""
    small = {"decoder": DecoderConfig().with_small(),
             "rrdbnet": rrdbnet.RRDBNetConfig().with_small(),
             "swinir": swinir.SwinIRConfig().with_small(),
             "hat": hat.HATConfig().with_small(),
             "swin2sr": swin2sr.Swin2SRConfig().with_small()}
    inits = {"decoder": params.init_decoder, "rrdbnet": rrdbnet.init_rrdbnet,
             "swinir": swinir.init_swinir, "hat": hat.init_hat,
             "swin2sr": swin2sr.init_swin2sr}
    fn = ENTRY_POINTS[name]
    if name == "load_upscale_model":
        sd = swinir.init_swinir(small["swinir"], device="cpu").state_dict()
        path = tmp_path / "swinir.pth"
        torch.save(sd, path)
        return fn(str(path))
    family = name.split("_")[-1] if name.startswith("init_") else \
        name.split("_")[0]
    if name.startswith("init_"):
        return fn(small[family], 0)
    sd = inits[family](small[family], 0, device="cpu").state_dict()
    if family == "decoder":
        return fn(sd, small[family])
    return fn(sd)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, tmp_path):
    default = inspect.signature(ENTRY_POINTS[name]).parameters[
        "device"].default
    assert default == "cuda"
    if not torch.cuda.is_available():
        # a CPU-only build asserts, a CUDA build without a device raises
        with pytest.raises((AssertionError, RuntimeError)):
            _call_without_device(name, tmp_path)
