"""A run with the timed path broken underneath reports ``correct``
false: the harness past its look for a card, on the CPU at small sizes.
Each fault a cell can have: a step that returns its state unchanged, an
answer altered where it is produced (an upscale's highlights alone too),
requests left unanswered.  (No cell spans chips, so none has an exchange
between chips to leave out.)"""

import time

import pytest

from benchmark.harness import runner
from benchmark.tests.bench_small import SECONDS, cell_names, small_cell


def _run(name, seed=2 ** 31 + 11):
    cell = small_cell(name)
    return runner.run_cell(cell, seed, SECONDS[cell.traffic["kind"]], False,
                           "cpu", 0.0, time.perf_counter())["result"]


def _kind(name):
    return small_cell(name).traffic["kind"]


@pytest.mark.parametrize("name", cell_names())
def test_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0


def _halves_doubled(image):
    out = image.clone()
    out[:, : out.shape[1] // 2] *= 2.0
    return out


@pytest.mark.parametrize("name", [n for n in cell_names()
                                  if _kind(n) == "decode_closed"])
def test_decode_state_unchanged(name, monkeypatch):
    from hdrvae_torch.decode import pipeline
    real, first = pipeline.hdr_decode, []

    def stale(*a, **kw):
        if not first:
            first.append(real(*a, **kw))
        return first[0]

    monkeypatch.setattr(pipeline, "hdr_decode", stale)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", [n for n in cell_names()
                                  if _kind(n) == "decode_closed"])
def test_decode_answer_altered(name, monkeypatch):
    from hdrvae_torch.decode import pipeline
    real = pipeline.hdr_decode
    monkeypatch.setattr(pipeline, "hdr_decode", lambda *a, **kw: real(
        *a, **kw)._replace(image=_halves_doubled(real(*a, **kw).image)))
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", [n for n in cell_names()
                                  if _kind(n) == "upscale_closed"])
def test_upscale_state_unchanged(name, monkeypatch):
    from hdrvae_torch.upscale import pipeline
    real, first = pipeline.hdr_upscale, []

    def stale(*a, **kw):
        if not first:
            first.append(real(*a, **kw))
        return first[0]

    monkeypatch.setattr(pipeline, "hdr_upscale", stale)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", [n for n in cell_names()
                                  if _kind(n) == "upscale_closed"])
def test_upscale_answer_altered(name, monkeypatch):
    from hdrvae_torch.upscale import pipeline
    real = pipeline.hdr_upscale

    def altered(*a, **kw):
        res = real(*a, **kw)
        return res._replace(image=_halves_doubled(res.image))

    monkeypatch.setattr(pipeline, "hdr_upscale", altered)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", [n for n in cell_names()
                                  if _kind(n) == "upscale_closed"])
def test_upscale_highlights_altered(name, monkeypatch):
    """A tenth more in the brightest 3 % of the image: below the 90th
    percentile of the gap, caught by the 99.9th."""
    from hdrvae_torch.upscale import pipeline
    real = pipeline.hdr_upscale

    def brighter(*a, **kw):
        res = real(*a, **kw)
        image = res.image.clone()
        top = image.reshape(-1).kthvalue(int(0.97 * image.numel())).values
        image[image > top] *= 1.1
        return res._replace(image=image)

    monkeypatch.setattr(pipeline, "hdr_upscale", brighter)
    result = _run(name)
    assert not result["correct"]
    assert result["check"]["p90_vs_bf16"]["value"] <= \
        result["check"]["p90_vs_bf16"]["limit"]


@pytest.mark.parametrize("name", [n for n in cell_names()
                                  if _kind(n) == "serve_open"])
def test_serve_half_the_requests_unanswered(name, monkeypatch):
    from hdrvae_torch.serve import engine
    real, calls = engine.ServeEngine._dispatch, [0]
    warmup = len(small_cell(name).traffic["mix"])

    def every_other(self, *a, **kw):
        calls[0] += 1
        if calls[0] > warmup and calls[0] % 2 == 0:
            raise RuntimeError("dropped")
        return real(self, *a, **kw)

    monkeypatch.setattr(engine.ServeEngine, "_dispatch", every_other)
    result = _run(name)
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("name", [n for n in cell_names()
                                  if _kind(n) == "serve_open"])
def test_serve_answer_altered(name, monkeypatch):
    from hdrvae_torch.serve import engine
    real = engine.hdr_decode

    def altered(*a, **kw):
        res = real(*a, **kw)
        return res._replace(image=_halves_doubled(res.image))

    monkeypatch.setattr(engine, "hdr_decode", altered)
    assert not _run(name)["correct"]
