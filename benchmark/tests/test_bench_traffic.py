"""The open-loop schedule is reproducible from its seed and holds the
same work for every seed; the trace reduction's arithmetic."""

import pytest

from benchmark.harness import trace, traffic

MIX = [{"latent_hw": [128, 128], "weight": 0.4},
       {"latent_hw": [104, 152], "weight": 0.3},
       {"latent_hw": [112, 144], "weight": 0.3}]


def test_schedule_reproducible():
    a = traffic.schedule(5.0, 40, MIX, 4, 2 ** 33 + 7)
    assert a == traffic.schedule(5.0, 40, MIX, 4, 2 ** 33 + 7)
    assert a != traffic.schedule(5.0, 40, MIX, 4, 2 ** 33 + 8)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5])
def test_every_seed_gets_the_same_work(seed):
    base = traffic.schedule(5.0, 40, MIX, 4, 12345)
    reqs = traffic.schedule(5.0, 40, MIX, 4, seed)
    assert len(reqs) == 200
    assert sorted(r.shape for r in reqs) == sorted(r.shape for r in base)
    gaps = lambda rs: sorted(round(b.due_s - a.due_s, 9)  # noqa: E731
                             for a, b in zip([traffic.Request(0, (0, 0), 0)]
                                             + rs[:-1], rs))
    assert gaps(reqs) == pytest.approx(gaps(base))
    assert reqs[-1].due_s == pytest.approx(40.0)
    assert all(a.due_s <= b.due_s for a, b in zip(reqs, reqs[1:]))
    assert {r.slot for r in reqs} <= set(range(4))


def test_shape_counts_round_to_the_total():
    assert traffic.shape_counts(MIX, 7) == [3, 2, 2]
    assert sum(traffic.shape_counts(MIX, 201)) == 201


def _ev(cat, ts, dur, name):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


def test_reduce_events():
    patterns = [{"file": "a.json", "class": "conv",
                 "patterns": ["conv_wgmma"]}]
    events = [_ev("cpu_op", 0, 100, "aten::outer"),
              _ev("cpu_op", 40, 10, "aten::inner"),
              _ev("kernel", 10, 20, "conv_wgmma_kernel<0>"),
              _ev("kernel", 25, 10, "other_kernel_1"),
              _ev("kernel", 60, 30, "conv_wgmma_kernel<0>"),
              _ev("gpu_memcpy", 95, 5, "Memcpy DtoH")]
    out = trace.reduce_events(events, patterns, 1e-4)
    assert out["busy_s"] == pytest.approx(60e-6)
    assert out["class_s"]["conv"] == pytest.approx(50e-6)
    assert out["class_s"]["other"] == pytest.approx(15e-6)
    idle = dict(out["idle_gaps"])
    # [0,10) and [90,95) under aten::outer only, [35,60) under aten::inner
    assert idle["host: aten::inner"] == pytest.approx(25e-6)
    assert idle["host: aten::outer"] == pytest.approx(15e-6)
    assert out["device_ops"][0] == ["conv_wgmma_kernel<0>",
                                    pytest.approx(50e-6)]


def test_no_device_operation_is_an_error():
    with pytest.raises(RuntimeError):
        trace.reduce_events([_ev("cpu_op", 0, 1, "x")], [], 1.0)
