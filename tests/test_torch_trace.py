"""The port's spans and counters (utils/profile.py) on the CPU.

Off the profiler a span enters no `record_function` and a counter keeps
nothing.  Under `torch.profiler` the record, the render and the replay
carry the `m3t.*` spans, nested as the wavefront runs them (`m3t.k1` in
`m3t.bounce` in `m3t.record.batch`), one `m3t.bounce` a bounce and one
`m3t.k1` a traversal, with `m3t.k1.rays` counting the rays the traversals
received and `m3t.shade.lanes` the lanes the bounces shaded (on the CPU
by the plain `_shade`, so `m3t.shade.kernel_lanes` stays absent); and the
image, the record and the gradients are bit-equal to an untraced run.  The test that every
wait of the card's paths lies in an `m3t.wait` span is in
test_torch_cuda.py (the CPU has no device to wait for).
"""
import contextlib
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mitsuba3_experiments_tpu_torch.integrators import persistent, replay_cuda, replay_grads
from mitsuba3_experiments_tpu_torch.integrators.replay import record_frame
from mitsuba3_experiments_tpu_torch.intersect import bvh_torch
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict, params
from mitsuba3_experiments_tpu_torch.utils import profile as prof_mod

torch.set_num_threads(2)

SEED, SPP, DEPTH, RES, LANES = 5, 2, 4, 8, 48
N_RAYS = RES * RES * SPP          # 128 camera rays: three batches of 48 lanes
CHUNK = 32
RECORD_SPANS = {"m3t.record.batch", "m3t.bounce", "m3t.k1", "m3t.shade", "m3t.compact",
                "m3t.wait"}
REPLAY_SPANS = {"m3t.replay.chunk", "m3t.replay.loss"}


@pytest.fixture(scope="module")
def scene():
    s, _ = load_dict(cornell_box(res=RES, spp=SPP), device="cpu")
    return s


def _render(scene):
    return (persistent.render_persistent(scene, seed=SEED, spp=SPP, max_depth=DEPTH,
                                         rfilter="tent", n_lanes=LANES),)


def _fwd_bwd(scene, mode):
    rec, rayL = record_frame(scene, SEED, N_RAYS, spp=SPP, max_depth=DEPTH, rr_depth=2,
                             n_lanes=LANES, pad_to=N_RAYS)
    p = {k: params.traverse(scene)[k] for k in ("materials.base_color", "emitters.radiance")}
    target = torch.full((RES, RES, 3), 0.25)
    g = replay_grads(scene, p, params.update, target, SEED, rec, N_RAYS, chunk=CHUNK, spp=SPP,
                     max_depth=DEPTH, rr_depth=2, mode=mode)
    return rec, rayL, g


class Span:
    """A `m3t.*` range of the profiler's own events (read from its raw
    results: building `prof.events()` over the plain traversal's half a
    million operators takes minutes)."""

    def __init__(self, e):
        self.name, self.thread = e.name(), e.start_thread_id()
        self.start, self.end = e.start_ns(), e.start_ns() + e.duration_ns()

    def inside(self, outer) -> bool:
        return (self.thread == outer.thread and outer.start <= self.start
                and self.end <= outer.end)


def _traced(fn, *args, **kwargs):
    """fn's output, its spans and the counters it added, under the profiler."""
    prof_mod.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kwargs)
    spans = [Span(e) for e in prof.profiler.kineto_results.events()
             if e.name().startswith("m3t.")]
    return out, spans, prof_mod.drain()


def _counted(fn, *args):
    """_traced(fn, *args) with _shade's calls, the wavefront's bounces (its
    calls from trace_rays), and the traversals and their rays counted
    apart."""
    seen = {"shade": 0, "bounces": 0, "lanes": 0, "queries": 0, "rays": 0}
    shade, traverse = persistent._shade, bvh_torch.traverse

    def counted_shade(scene, seed, doneA, hit_o, *a, **k):
        seen["shade"] += 1
        if sys._getframe(1).f_code.co_name == "trace_rays":
            seen["bounces"] += 1
            seen["lanes"] += doneA.shape[0]
        return shade(scene, seed, doneA, hit_o, *a, **k)

    def counted_traverse(unified, n_nodes, o, *a, **k):
        seen["queries"] += 1
        seen["rays"] += o.shape[0]
        return traverse(unified, n_nodes, o, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(persistent, "_shade", counted_shade)
        mp.setattr(bvh_torch, "traverse", counted_traverse)
        return (*_traced(fn, *args), seen)


@pytest.fixture(scope="module")
def runs(scene):
    """{"render" | "full" | "sorted": (untraced output, traced output, spans,
    counters, seen)}."""
    out = {}
    for name, fn, args in (("render", _render, ()), ("full", _fwd_bwd, ("full",)),
                           ("sorted", _fwd_bwd, ("sorted",))):
        out[name] = (fn(scene, *args), *_counted(fn, scene, *args))
    return out


def test_spans_off_enter_no_record_function(scene, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(prof_mod, "record_function", refuse)
    prof_mod.drain()
    (img,) = _render(scene)
    assert img.shape == (RES, RES, 3)
    assert prof_mod.drain() == {}
    prof_mod.count("m3t.k1.rays", torch.tensor(3))   # off: nothing is read


def _check_record(spans, counts, seen):
    by = {}
    for e in spans:
        by.setdefault(e.name, []).append(e)
    assert len(by["m3t.record.batch"]) == -(-N_RAYS // LANES)
    assert len(by["m3t.bounce"]) == seen["bounces"] > len(by["m3t.record.batch"])
    assert len(by["m3t.shade"]) == seen["shade"]
    assert len(by["m3t.wait"]) > len(by["m3t.bounce"])
    assert len(by["m3t.k1"]) == seen["queries"] > len(by["m3t.bounce"])   # closest and any hit
    for k1 in by["m3t.k1"]:
        b = [e for e in by["m3t.bounce"] if k1.inside(e)]
        assert len(b) == 1 and any(b[0].inside(r) for r in by["m3t.record.batch"])
    assert counts["m3t.k1.rays"] == seen["rays"]
    assert seen["rays"] >= N_RAYS
    assert counts["m3t.shade.lanes"] == seen["lanes"] >= N_RAYS
    assert "m3t.shade.kernel_lanes" not in counts


def test_render_spans_nest_and_count(runs):
    _, _, spans, counts, seen = runs["render"]
    assert {e.name for e in spans} == RECORD_SPANS | {"m3t.splat"}
    assert sum(e.name == "m3t.splat" for e in spans) == 1
    assert set(counts) == {"m3t.k1.rays", "m3t.shade.lanes"}
    _check_record(spans, counts, seen)


@pytest.mark.parametrize("mode", ["full", "sorted"])
def test_fwd_bwd_spans_and_counts(runs, scene, mode):
    _, _, spans, counts, seen = runs[mode]
    assert {e.name for e in spans} == RECORD_SPANS | REPLAY_SPANS
    chunks = [e for e in spans if e.name == "m3t.replay.chunk"]
    # the sorted mode without the recorder's film makes it in a forward pass
    assert len(chunks) == N_RAYS // CHUNK * (2 if mode == "sorted" else 1)
    # the CPU's plain replay shades too, inside its chunks
    replayed = sum(e.name == "m3t.shade" and any(e.inside(c) for c in chunks) for e in spans)
    assert replayed == seen["shade"] - seen["bounces"] > 0
    _check_record(spans, counts, seen)
    # K5's packing runs on any device: its span, around the CPU call
    rec = runs[mode][0][0]
    _, spans, _ = _traced(replay_cuda.pack_args, scene, rec, SEED, 0, spp=SPP,
                          max_depth=DEPTH, rr_depth=2)
    pack, wait = sorted(spans, key=lambda e: e.start)
    assert (pack.name, wait.name) == ("m3t.k5.pack", "m3t.wait")   # its Fresnel upload
    assert wait.inside(pack)


def test_outputs_bit_equal_traced_and_not(runs):
    for name, (plain, traced, *_) in runs.items():
        for a, b in zip(plain[:2], traced[:2]):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), name
            else:   # a PathRecord
                for f in ("prim", "u", "v", "occl"):
                    assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
        if name != "render":
            g, g_t = plain[2], traced[2]
            for k in g:
                assert float(g[k].abs().max()) > 0 and torch.equal(g[k], g_t[k]), (name, k)


def test_counters_refuse_device_values_and_stay_exact_across_threads(monkeypatch):
    # the profiler is on for the calling thread only (and autograd's own
    # threads), so the threads' view of it is forced on here
    monkeypatch.setattr(prof_mod, "_profiling", lambda: True)
    with pytest.raises(TypeError):
        prof_mod.count("m3t.k1.rays", torch.tensor(3))
    prof_mod.drain()
    opened = threading.local()                           # the ranges open on each thread
    record_function = prof_mod.record_function

    @contextlib.contextmanager
    def tracked(name):
        stack = opened.__dict__.setdefault("stack", [])
        stack.append(name)
        try:
            with record_function(name):
                yield
        finally:
            stack.pop()

    monkeypatch.setattr(prof_mod, "record_function", tracked)
    n_threads, n_adds = 16, 2000
    stacks_ok = []

    def work(i):
        ok = True
        for _ in range(n_adds):
            with prof_mod.span(f"t{i}"):
                prof_mod.count("adds")
                ok &= opened.stack == [f"t{i}"]
        stacks_ok.append(ok and opened.stack == [])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert stacks_ok == [True] * n_threads
    assert prof_mod.drain() == {"adds": n_threads * n_adds}
    assert prof_mod.drain() == {}
