"""The VAE handle, as ``hdrvae/api/vae.py``: a loaded decoder with its
topology, numerics tier and device, which the serving engine and user code
share."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hdrvae_torch.core.config import DecoderConfig, Precision
from hdrvae_torch.models.decoder import Decoder, DecodeOutput, decoder_apply
from hdrvae_torch.models.params import init_decoder, load_decoder


@dataclasses.dataclass
class VAE:
    """Decoder weights and topology, loadable from Flux.1's
    ``ae.safetensors`` (or an SD / SDXL VAE)."""

    decoder: Decoder
    precision: Precision = Precision()

    @property
    def config(self) -> DecoderConfig:
        return self.decoder.cfg

    @property
    def device(self) -> torch.device:
        return next(self.decoder.parameters()).device

    @classmethod
    def load(cls, path: str, config: Optional[DecoderConfig] = None,
             precision: Precision = Precision(), *,
             device: torch.device | str = "cuda") -> "VAE":
        """Load from a safetensors checkpoint onto ``device``.
        ``config=None`` infers the topology from the checkpoint's shapes
        (Flux.1 z = 16, SD1.5 / SDXL z = 4)."""
        return cls(decoder=load_decoder(path, config, device=device),
                   precision=precision)

    @classmethod
    def random_init(cls, seed: int = 0,
                    config: DecoderConfig = DecoderConfig(),
                    precision: Precision = Precision(), *,
                    device: torch.device | str = "cuda") -> "VAE":
        """Random weights drawn with numpy from ``seed`` (fixtures and
        cold-start testing).  The same seed does not give the JAX
        package's ``random_init`` weights: those come from a JAX PRNG key;
        carry JAX weights across with ``models.params.state_dict_from_jax``
        instead."""
        return cls(decoder=init_decoder(config, seed, device=device),
                   precision=precision)

    @torch.no_grad()
    def decode(self, latent, *, apply_conv_out: bool = True
               ) -> DecodeOutput:
        """One decoder forward of ``latent`` ([B, h, w, z] NHWC; a numpy
        array or a tensor, moved to the handle's device)."""
        if not isinstance(latent, torch.Tensor):
            latent = torch.from_numpy(np.asarray(latent, np.float32))
        return decoder_apply(self.decoder, latent.to(self.device),
                             precision=self.precision,
                             apply_conv_out=apply_conv_out)
