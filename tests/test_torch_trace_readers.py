"""The benchmark's readers of the port's spans and counters
(benchmark/layer_metrics/_spans.py and the metrics built on it), on
synthetic profiler events: the device-idle time by the innermost `m3t.*`
span open at each gap's start, the `m3t.wait` count a traced step, and
`k1_rays_per_launch` from the rays counter drained, and the launch
counters read, once a traced step, `shade_kernel_share` from the
shading's lane counters and `replay_step_share` from the replay's row
counters.  A trace or a program without the port's spans and
counters leaves each reader empty."""
import sys
import types
from types import SimpleNamespace

import pytest

from benchmark import harness
from mitsuba3_experiments_tpu_torch.utils import profile as prof_mod

PKG = "mitsuba3_experiments_tpu_torch"
FB, R = "fwd_bwd_rays_per_s", "fwd_rays_per_s"


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _ker(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": ts, "dur": dur}


def _trace(with_spans=True, with_device=True):
    """Two traced steps (0-100 and 200-300 us).  Step one: a bounce whose
    shading leaves the device idle 12-20 and 30-47, then a wait after which
    it idles 60-85.  Step two: a replay chunk idle 205-215 in K5's packing,
    250-260 in the loss, 280-295 in the chunk.  A wait between the steps
    (150) lies outside them."""
    ev = [_ann(harness.STEP_SPAN, 0, 100), _ann(harness.STEP_SPAN, 200, 100),
          _ann("record", 0, 90), _ann("replay", 200, 100)]
    if with_spans:
        ev += [_ann("m3t.bounce", 5, 75), _ann("m3t.shade", 10, 30), _ann("m3t.wait", 40, 5),
               _ann("m3t.wait", 60, 2), _ann("m3t.wait", 150, 1),
               _ann("m3t.replay.chunk", 200, 90), _ann("m3t.k5.pack", 205, 10),
               _ann("m3t.wait", 220, 1), _ann("m3t.replay.loss", 250, 20)]
    if with_device:
        ev += [_ker(a, b - a) for a, b in ((0, 12), (20, 30), (47, 60), (85, 100), (200, 205),
                                           (215, 250), (260, 280), (295, 300))]
    return harness.Trace(ev, 2)


def _reader(name):
    return harness.load_reader(harness.HERE, name)


class _Port:
    """The port's package name and launch counters, as `loops.Port` has them."""

    def __init__(self, pkg):
        self.PKG, self.k1, self.plain = pkg, 0, 0

    def counters(self):
        return {"k1": self.k1, "plain_traversals": self.plain, "k5_forward": 0}


def _ctx(metric, trace, pkg=PKG, step=1):
    loop = SimpleNamespace(metric=metric, port=_Port(pkg), steps_taken=step)
    return {"trace": trace, "loop": loop, "collected": {}, "counters": loop.port.counters()}


def test_idle_by_span_and_wait_count():
    tr = _trace()
    # every gap, named by the innermost span open at its start
    gaps = sorted(tr.idle_gaps(len(tr.device) + len(tr.steps)), key=lambda g: g[1])
    assert [g[0] for g in gaps] == ["m3t.shade", "m3t.k5.pack", "m3t.replay.loss",
                                    "m3t.replay.chunk", "m3t.shade", "m3t.wait"]
    fb = _ctx(FB, tr)
    assert _reader("shade_idle_ms.fwd_bwd").read(fb) == pytest.approx((8 + 17) * 1e-3 / 2)
    assert _reader("replay_host_idle_ms").read(fb) == pytest.approx((10 + 10 + 15) * 1e-3 / 2)
    assert _reader("host_waits.fwd_bwd").read(fb) == 1.5          # the wait at 150 is left out
    assert fb["collected"]["m3t.idle_ms"]["m3t.wait"] == pytest.approx(25e-3)
    r = _ctx(R, tr)
    assert _reader("shade_idle_ms.render").read(r) == pytest.approx(25e-3 / 2)
    assert _reader("host_waits.render").read(r) == 1.5
    # another loop's metrics stay empty
    for name in ("shade_idle_ms.render", "host_waits.render", "k1_rays_per_launch.render"):
        assert _reader(name).read(_ctx(FB, tr)) is None
    for name in ("replay_host_idle_ms", "host_waits.fwd_bwd"):
        assert _reader(name).read(_ctx(R, tr)) is None


def test_readers_are_empty_without_the_ports_spans_or_a_device():
    names = ("host_waits.fwd_bwd", "shade_idle_ms.fwd_bwd", "replay_host_idle_ms")
    for name in names:
        assert _reader(name).read(_ctx(FB, _trace(with_spans=False))) is None
        assert _reader(name).read(_ctx(FB, None)) is None
    host_only = _ctx(FB, _trace(with_device=False))     # a CPU run: spans, no device
    assert _reader("shade_idle_ms.fwd_bwd").read(host_only) is None
    assert _reader("host_waits.fwd_bwd").read(host_only) == 1.5


def test_k1_rays_per_launch_from_counters_drained_once_a_step(monkeypatch):
    monkeypatch.setattr(prof_mod, "_profiling", lambda: True)
    prof_mod.drain()
    fwd_bwd, render = _reader("k1_rays_per_launch.fwd_bwd"), _reader("k1_rays_per_launch.render")
    assert fwd_bwd.collect is render.collect
    ctx = _ctx(R, None)
    port = ctx["loop"].port
    port.k1 = 40                                         # the untraced window's launches
    ctx["counters"] = port.counters()
    assert render.read(ctx) is None                      # nothing collected yet
    port.k1 += 2
    prof_mod.count("m3t.k1.rays", 300)
    render.collect(ctx, {})
    port.k1 += 1
    prof_mod.count("m3t.k1.rays", 100)                   # after the step's drain
    fwd_bwd.collect(ctx, {})                             # the same step: no second drain
    assert ctx["collected"]["m3t.counts"] == {"m3t.k1.rays": 300}
    assert ctx["collected"]["k1_launches"] == 2
    assert render.read(ctx) == 150.0
    ctx["loop"].steps_taken = 2
    port.plain += 1                                      # a plain traversal counts as one
    prof_mod.count("m3t.k1.rays", 200)
    render.collect(ctx, {})
    assert render.read(ctx) == pytest.approx((300 + 100 + 200) / 4)
    assert fwd_bwd.read(ctx) is None                     # another loop's metric
    assert prof_mod.drain() == {}


def test_k1_rays_per_launch_is_empty_without_the_ports_counters(monkeypatch):
    old = types.ModuleType("old_port.utils.profile")     # a profile module without drain
    monkeypatch.setitem(sys.modules, "old_port.utils.profile", old)
    for pkg in ("old_port", "no_such_port"):
        ctx = _ctx(FB, None, pkg=pkg)
        rd = _reader("k1_rays_per_launch.fwd_bwd")
        rd.collect(ctx, {})
        assert rd.read(ctx) is None


def test_shade_kernel_share_from_the_drained_counters(monkeypatch):
    monkeypatch.setattr(prof_mod, "_profiling", lambda: True)
    prof_mod.drain()
    render, fwd_bwd = _reader("shade_kernel_share.render"), _reader("shade_kernel_share.fwd_bwd")
    assert render.collect is fwd_bwd.collect is _reader("k1_rays_per_launch.render").collect
    for kernel in (True, False):                         # the card's wavefront, the CPU's
        ctx = _ctx(FB, None)
        assert fwd_bwd.read(ctx) is None                 # nothing collected yet
        for step, lanes in ((1, 2_000), (2, 500)):
            ctx["loop"].steps_taken = step
            prof_mod.count("m3t.shade.lanes", lanes)
            if kernel:
                prof_mod.count("m3t.shade.kernel_lanes", lanes)
            fwd_bwd.collect(ctx, {})
        assert fwd_bwd.read(ctx) == (100.0 if kernel else 0.0)
        assert render.read(ctx) is None                  # another loop's metric
    old = types.ModuleType("old_port.utils.profile")     # a program without the counters
    monkeypatch.setitem(sys.modules, "old_port.utils.profile", old)
    ctx = _ctx(R, None, pkg="old_port")
    render.collect(ctx, {})
    assert render.read(ctx) is None
    ctx = _ctx(R, None)
    prof_mod.count("m3t.k1.rays", 10)                    # the parent's counters alone
    render.collect(ctx, {})
    assert render.read(ctx) is None
    assert prof_mod.drain() == {}


def test_replay_step_share_from_the_drained_counters(monkeypatch):
    monkeypatch.setattr(prof_mod, "_profiling", lambda: True)
    prof_mod.drain()
    share = _reader("replay_step_share.fwd_bwd")
    assert share.collect is _reader("k1_rays_per_launch.fwd_bwd").collect
    for step_rows in (True, False):                      # the step-level loop, the Function's
        ctx = _ctx(FB, None)
        assert share.read(ctx) is None                   # nothing collected yet
        for step in (1, 2):
            ctx["loop"].steps_taken = step
            prof_mod.count("m3t.k5.rows", 3 * 131_072)
            if step_rows:
                prof_mod.count("m3t.replay.step_rows", 3 * 131_072)
            share.collect(ctx, {})
        assert share.read(ctx) == (100.0 if step_rows else None)
        assert share.read(_ctx(R, None)) is None         # another loop's metric
    ctx = _ctx(FB, None)
    prof_mod.count("m3t.k5.rows", 200)                   # a chunk outside the step-level loop
    prof_mod.count("m3t.replay.step_rows", 150)
    share.collect(ctx, {})
    assert share.read(ctx) == 75.0
    old = types.ModuleType("old_port.utils.profile")     # a program without the counters
    monkeypatch.setitem(sys.modules, "old_port.utils.profile", old)
    ctx = _ctx(FB, None, pkg="old_port")
    share.collect(ctx, {})
    assert share.read(ctx) is None
    assert prof_mod.drain() == {}
