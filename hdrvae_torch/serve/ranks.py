"""Serving across ranks, the counterpart of the JAX engine's ``mesh=``
(``hdrvae/serve/engine.py:293-303``): one :class:`ServeEngine` on rank 0
of a process group serves the exact slab-sharded decode
(``sharding/mesh.py::sharded_slab_decode``), which every rank runs in
lockstep.

The JAX package needs no such module: one SPMD program drives every
device.  The port's ranks are processes (``sharding/multihost.py``), so
rank 0 tells the others what to decode, one message at a time:

- a header, ``HEADER_LEN`` int64s all-reduced by sum: rank 0 writes it and
  every other rank adds zeros.  An all-reduce, not a broadcast, because it
  completes only once every rank has joined it, so rank 0 learns that each
  follower is alive (a dead one's closed connection fails it at once).
  Its fields: the kind (:data:`REQUEST`, :data:`HEARTBEAT` or
  :data:`STOP`), the request's sequence number, the NHWC latent's shape
  (rank 0 turns an NCHW latent over before it is sent), ``pad_to`` ((0, 0)
  for none) and the byte length of the request's settings;
- after a REQUEST header, two broadcasts from rank 0: the float32 latent,
  and the request's ``(HDRDecodeConfig, Precision)`` pickled (an HTTP
  request may override ``mode`` and ``ev``, and one rank group may serve
  several engines in turn, each in its own tier); then
  ``sharded_slab_decode`` with those arguments on every rank;
- HEARTBEAT: rank 0's worker sends one whenever its queue has been empty
  for the engine's ``heartbeat_s``, so that a follower idle between
  requests never waits in a collective as long as the group's timeout,
  and a dead follower is found while the server idles;
- STOP: sent when the engine closes; every follower returns.

Why every rank calls the same collectives in the same order: on rank 0
one thread calls them all, the engine's worker (HTTP handler threads and
``submit`` only queue requests); on every other rank the main thread runs
:func:`follow`.  For each message both sides take the same steps, and the
collectives of ``sharded_slab_decode`` depend only on the latent's shape,
``pad_to``, the settings and the weights, which are the same on every rank
(:func:`check_weights` compares the weights when the engine starts).
Rank 0 validates a request in full before its header goes out
(:func:`check_request`), so a request that would fail never reaches the
others.  Anything that fails after a header went out may leave the ranks
out of step: it raises :class:`GroupBroken`, and the engine then fails
that request, every queued one and every later submit.  A follower that
fails raises out of :func:`follow` and its process exits, which fails
rank 0's next collective.

The tensors travel on the CPU over gloo and on the rank's card over NCCL.
The settings are pickled by rank 0 of the same program, so unpickling them
runs nothing that program did not send.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pickle
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from hdrvae_torch.core.config import HDRDecodeConfig, Precision
from hdrvae_torch.sharding.mesh import Mesh, _use_chain, sharded_slab_decode

REQUEST, HEARTBEAT, STOP = 1, 2, 3
# kind, sequence number, b, h, w, z, pad_to (h, w), settings' byte length
HEADER_LEN = 9


class GroupBroken(RuntimeError):
    """The ranks may be out of step: the group can serve no more
    requests."""


class WeightsDiffer(RuntimeError):
    """The ranks hold different decoder weights: they refuse to serve."""


def _wire(mesh: Mesh) -> torch.device:
    """Where the protocol's tensors travel: the card on NCCL, else the
    CPU."""
    if mesh.joined and dist.get_backend() == "nccl":
        return mesh.device
    return torch.device("cpu")


def weights_digest(module: torch.nn.Module) -> bytes:
    """sha256 over every entry of ``module``'s state dict (its name, dtype,
    shape and bytes), in name order."""
    from hdrvae_torch.sharding.multihost import digest
    h = hashlib.sha256()
    for name, t in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(digest(t).encode())
    return h.digest()


def check_weights(decoder: torch.nn.Module, mesh: Mesh) -> None:
    """Compare every rank's :func:`weights_digest` (one all-gather, so
    every rank of ``mesh`` calls it); raises :class:`WeightsDiffer` on
    every rank if any two differ."""
    mine = torch.tensor(list(weights_digest(decoder)), dtype=torch.uint8)
    every = mesh.all_gather(mine.to(_wire(mesh)))
    other = [r for r, d in enumerate(every) if not torch.equal(d.cpu(), mine)]
    if other:
        raise WeightsDiffer(f"rank(s) {other} hold other decoder weights "
                            f"than rank {mesh.rank}")


def check_request(latent: torch.Tensor, cfg: HDRDecodeConfig,
                  precision: Precision, pad_to: Optional[Tuple[int, int]],
                  num_levels: int) -> None:
    """Raise ``ValueError`` for a request that would fail on the ranks:
    an empty latent ([B, h, w, z] NHWC, z already checked), an unknown
    mode, a ``pad_to`` smaller than the latent, or a tier the slab tail
    cannot run (``mesh._use_chain``)."""
    b, h, w, _ = latent.shape
    if min(b, h, w) < 1:
        raise ValueError(f"empty latent {tuple(latent.shape)}")
    cfg.canonical_mode()
    if pad_to is not None and (pad_to[0] < h or pad_to[1] < w):
        raise ValueError(f"pad_to {tuple(pad_to)} smaller than latent "
                         f"{(h, w)}")
    _use_chain(precision, b, min(2, num_levels), pad_to is not None)


@dataclasses.dataclass
class Message:
    """One message as a follower receives it."""

    kind: int
    seq: int = 0
    latent: Optional[torch.Tensor] = None     # [B, h, w, z] float32
    cfg: Optional[HDRDecodeConfig] = None
    precision: Optional[Precision] = None
    pad_to: Optional[Tuple[int, int]] = None


class Link:
    """One rank's end of the protocol over ``mesh``: :meth:`send` on rank
    0, :meth:`receive` on the others."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.wire = _wire(mesh)
        self.seq = 0

    def _header(self, fields: List[int]) -> List[int]:
        t = torch.tensor(fields, dtype=torch.int64, device=self.wire)
        return self.mesh.all_reduce(t).tolist()

    def send(self, kind: int, latent: Optional[torch.Tensor] = None,
             cfg: Optional[HDRDecodeConfig] = None,
             precision: Optional[Precision] = None,
             pad_to: Optional[Tuple[int, int]] = None) -> None:
        """Rank 0: one message (a REQUEST with its NHWC latent, settings
        and bucket).  Raises :class:`GroupBroken` if a collective fails."""
        try:
            if kind != REQUEST:
                self._header([kind] + [0] * (HEADER_LEN - 1))
                return
            self.seq += 1
            blob = pickle.dumps((cfg, precision))
            self._header([REQUEST, self.seq, *latent.shape,
                          *(pad_to or (0, 0)), len(blob)])
            self.mesh.broadcast(latent.to(self.wire, torch.float32)
                                .contiguous())
            self.mesh.broadcast(torch.tensor(list(blob), dtype=torch.uint8,
                                             device=self.wire))
        except Exception as e:
            raise GroupBroken(f"sending to the ranks failed: {e}") from e

    def receive(self) -> Message:
        """A follower: the next message from rank 0."""
        kind, seq, b, h, w, z, ph, pw, n = self._header([0] * HEADER_LEN)
        if kind in (HEARTBEAT, STOP):
            return Message(kind)
        if kind != REQUEST or seq != self.seq + 1:
            raise GroupBroken(f"header kind {kind}, request {seq} after "
                              f"{self.seq}: the ranks are out of step")
        self.seq = seq
        latent = self.mesh.broadcast(torch.empty(
            (b, h, w, z), dtype=torch.float32, device=self.wire))
        blob = self.mesh.broadcast(torch.empty(n, dtype=torch.uint8,
                                               device=self.wire))
        cfg, precision = pickle.loads(blob.cpu().numpy().tobytes())
        return Message(REQUEST, seq, latent, cfg, precision,
                       (ph, pw) if ph else None)


@torch.no_grad()
def follow(decoder, mesh: Mesh) -> dict:
    """A follower's loop (module docstring): compare the weights with
    every rank's, then decode each request rank 0 sends until it sends
    STOP.  Returns ``{"served": requests decoded, "heartbeats": n}``.
    Raises :class:`WeightsDiffer` at start if the weights differ; any
    other failure raises out (the ranks are then out of step)."""
    check_weights(decoder, mesh)
    link = Link(mesh)
    served = heartbeats = 0
    while True:
        msg = link.receive()
        if msg.kind == STOP:
            return {"served": served, "heartbeats": heartbeats}
        if msg.kind == HEARTBEAT:
            heartbeats += 1
            continue
        sharded_slab_decode(decoder, msg.latent.to(mesh.device), msg.cfg,
                            mesh=mesh, pad_to=msg.pad_to,
                            precision=msg.precision)
        served += 1
