"""A run with the timed path broken underneath comes out not correct.  Each
test drives the whole of a run but the look for a card (`run.run_cell` on
the CPU at the tiny size, which runs the port's plain paths) with one fault
planted in the port: a step that leaves the state unchanged, half of the
batch left out with the mean taken over the rest, an answer altered where it
is produced.  (One chip a cell: no exchange between chips to leave out.)"""
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench_tiny  # noqa: E402

from benchmark import run  # noqa: E402

integ = pytest.importorskip("mitsuba3_experiments_tpu_torch.integrators")


def _run(tmp_path, cell, depth: int = 4):
    root = bench_tiny.make_root(tmp_path, depth=depth)
    line, _ = run.run_cell(cell, 2**31 + 77, 0.1, False, device="cpu", root=root,
                           cache=str(tmp_path / "cache"), log=lambda s: None)
    return json.loads(line)


def _zero_grads(real):
    def replay_grads(*a, **k):
        return {key: torch.zeros_like(v) for key, v in real(*a, **k).items()}
    return replay_grads


def _half_record(real):
    def record_full_pipelined(scene, seed, n_rays, **k):
        rec, film = real(scene, seed, n_rays // 2, **k)    # the rest left out ...
        return rec, film * 2.0                              # ... its mean over the half
    return record_full_pipelined


def _half_grads(real):
    def replay_grads(scene, params, update, target, seed, rec, n_rays, **k):
        half = rec.rows(slice(0, rec.prim.shape[0] // 2))
        g = real(scene, params, update, target, seed, half, min(n_rays, half.prim.shape[0]), **k)
        return {key: 2.0 * v for key, v in g.items()}
    return replay_grads


def _altered_uv(real):
    def record_full_pipelined(*a, **k):
        rec, film = real(*a, **k)
        rec.u[rec.prim >= 0] += 1e-3                        # a hit moved where it is made
        return rec, film
    return record_full_pipelined


def _altered_grad(real):
    def replay_grads(*a, **k):
        g = real(*a, **k)
        g["materials.base_color"][0, 0] += 1.0 + g["materials.base_color"].abs().max()
        return g
    return replay_grads


@pytest.mark.parametrize("name,fault,number", [
    ("replay_grads", _zero_grads, "grad_gap"),                     # state left unchanged
    ("record_full_pipelined", _half_record, "record_off"),         # half of the rays
    ("replay_grads", _half_grads, "grad_gap"),                     # half of the chunks
    ("record_full_pipelined", _altered_uv, "record_off"),          # a hit altered
    ("replay_grads", _altered_grad, "grad_gap"),                   # a gradient altered
])
def test_inverse_faults_are_not_correct(tmp_path, monkeypatch, name, fault, number):
    monkeypatch.setattr(integ, name, fault(getattr(integ, name)))
    out = _run(tmp_path, "tiny-fwd-bwd")
    assert out["correct"] is False
    c = out["checks"][number]
    assert c["value"] > c["limit"]


def _half_spp(real):
    def render_pipelined(scene, spp, **k):
        return real(scene, spp=max(1, spp // 2), **k)      # the mean over half the samples
    return render_pipelined


def _altered_image(real):
    def render_pipelined(*a, **k):
        return real(*a, **k) * 1.01
    return render_pipelined


@pytest.mark.parametrize("fault", [_half_spp, _altered_image])
def test_render_faults_are_not_correct(tmp_path, monkeypatch, fault):
    real = integ.render_pipelined
    calls = []

    def once_sound(*a, **k):             # the set-up's warm frame stays sound
        calls.append(1)
        return (real if len(calls) == 1 else fault(real))(*a, **k)

    monkeypatch.setattr(integ, "render_pipelined", once_sound)
    out = _run(tmp_path, "tiny-render")
    assert out["correct"] is False
    assert out["checks"]["image_off"]["value"] > out["checks"]["image_off"]["limit"]


@pytest.mark.parametrize("depth", [4, 16])     # full and sorted replays
def test_a_sound_run_is_correct(tmp_path, depth):
    out = _run(tmp_path, "tiny-fwd-bwd", depth)
    assert out["correct"] is True
    assert set(out["checks"]) == {"target_off", "record_off", "grad_gap"}
