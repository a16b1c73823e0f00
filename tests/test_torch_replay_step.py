"""replay_grads' step-level loop on the card (`replay._CardReplay`), run on
the CPU: `replay._on_card` patched to True and K5's two launches to its
host build (tests/torch_replay_host.py), whose adjoint adds into the
caller's buffers as the kernel does.

  * The full and sorted gradients equal the same mode's per-chunk autograd
    round through `ReplayRadiance` under the same patch (full: the sum of
    `_replay_grad_impl` over the chunks; sorted: the sum of `_grad` of each
    chunk's <adj, splat>), within rtol 1e-5 / atol 1e-6 max|g|, and the
    plain CPU path (`replay_radiance_plain` under autograd) within K5's host
    tolerance, rtol 1e-3 / atol 1e-4 max|g|.  The parameters reach the
    tables through a nonlinear `update_fn` (log radiance), as the
    benchmark's inverse loop passes them, and one key reaches none.
  * A call packs the scene once, calls `torch.autograd.grad` only after its
    chunk loop, opens one `m3t.replay.chunk` a chunk (and one more a chunk
    for the sorted mode's film pass), launches one K5 forward and one
    adjoint a chunk, and counts every replayed row in
    `m3t.replay.step_rows`.
  * Where K5's forward gives a non-finite channel, no derivative passes
    through it, as in the per-chunk round.
  * A key K5 does not differentiate raises before anything is packed.
  * `render.film.put_adjoint`, the dL of a film adjoint, is autograd's
    through `film.put` for each filter, with non-finite radiance, inactive
    rows and positions off the film; and a chunk's dL as the full mode
    forms it (`_put`, `_film_adjoint`, `_splat_adjoint`) is autograd's through the
    chunk's splat, develop and masked squared error.
"""
import contextlib
import functools

import pytest
import torch

import torch_replay_host as host
from mitsuba3_experiments_tpu_torch.integrators import PathRecord, replay, replay_cuda, \
    replay_grads
from mitsuba3_experiments_tpu_torch.render import film as filmlib
from mitsuba3_experiments_tpu_torch.scene import load_dict, params
from mitsuba3_experiments_tpu_torch.utils import profile as prof_mod
from test_torch_replay_kernel import DEPTH, RR, SCENES, SEED, SPP, record_of

KW = dict(spp=SPP, max_depth=DEPTH, rr_depth=RR, rfilter="box")
LOG_RAD = "log_radiance"
_built: dict = {}


def update(scene, p):
    """The tables of `p`: base colours as they are, radiance from its log
    (the key "unused" reaches no table)."""
    return params.update(scene, {"materials.base_color": p["materials.base_color"],
                                 "emitters.radiance": torch.exp(p[LOG_RAD])})


def _case(name):
    """(scene, padded rows, record, target, params) of SCENES[name], built
    and recorded once."""
    if name not in _built:
        scene = load_dict(SCENES[name](), device="cpu")[0]
        n, pad, rec = record_of(scene)
        w, h = scene.camera.resolution
        target = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(0)) * 0.5
        t = params.traverse(scene)
        p = {"materials.base_color": t["materials.base_color"].detach().clone(),
             LOG_RAD: torch.log(torch.clamp(t["emitters.radiance"].detach(), min=1e-6)),
             "unused": torch.ones(4)}
        _built[name] = (scene, n, pad, PathRecord(**{k: torch.as_tensor(v)
                                                     for k, v in rec.items()}), target, p)
    return _built[name]


@pytest.fixture
def on_card(monkeypatch):
    """The card's path on CPU tensors: {"fwd": K5 forward calls, "adj":
    adjoint calls, "pack": pack_scene calls}."""
    calls = {"fwd": 0, "adj": 0, "pack": 0}

    def counted(key, fn):
        @functools.wraps(fn)
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(replay, "_on_card", lambda device: True)
    monkeypatch.setattr(replay_cuda, "replay_forward", counted("fwd", host.forward_packed))
    monkeypatch.setattr(replay_cuda, "replay_adjoint", counted("adj", host.adjoint_packed))
    monkeypatch.setattr(replay_cuda, "pack_scene", counted("pack", replay_cuda.pack_scene))
    return calls


def _per_chunk(mode, scene, p, rec, target, n, chunk):
    """The same mode's gradients as a per-chunk autograd round through
    ReplayRadiance (replay_radiance on the patched card)."""
    if mode == "full":
        acc = None
        for off in range(0, rec.prim.shape[0], chunk):
            g = replay._replay_grad_impl(scene, p, update, rec.rows(slice(off, off + chunk)),
                                         target, SEED, off, min(off + chunk, n), **KW)
            acc = replay._add(acc, g)
        return acc
    lens = replay.path_lengths(rec)
    order = torch.argsort(-lens, stable=True)
    classes = replay._depth_classes(DEPTH)
    film = None
    with torch.no_grad():
        parts = []
        for j in range(rec.prim.shape[0] // chunk):
            oj = order[j * chunk:(j + 1) * chunk]
            steps = min(c for c in classes if c >= int(lens[oj].max()))
            L, pos, act0 = replay.replay_radiance(update(scene, p), rec.rows(oj), SEED, 0,
                                                  idx=oj, n_steps=steps, ray_end=n, spp=SPP,
                                                  max_depth=DEPTH, rr_depth=RR)
            parts.append((oj, steps))
            s = replay._splat(scene, L, pos, act0, "box")
            film = s if film is None else film + s
    adj = replay._film_adjoint(film, target)
    acc = None
    for oj, steps in parts:
        def inner(s, oj=oj, steps=steps):
            L, pos, act0 = replay.replay_radiance(s, rec.rows(oj), SEED, 0, idx=oj,
                                                  n_steps=steps, ray_end=n, spp=SPP,
                                                  max_depth=DEPTH, rr_depth=RR)
            return (adj * replay._splat(s, L, pos, act0, "box")[..., :3]).sum()
        acc = replay._add(acc, replay._grad(scene, p, update, inner))
    return acc


def _close(got, ref, rtol, atol_of_max, what):
    for k, r in ref.items():
        scale = float(r.abs().max())
        if k == "unused":
            assert torch.equal(got[k], torch.zeros(4)), what
            continue
        assert scale > 0 and bool(torch.isfinite(got[k]).all()), (what, k)
        torch.testing.assert_close(got[k], r, rtol=rtol, atol=atol_of_max * scale,
                                   msg=lambda m, k=k: f"{what} {k}: {m}")


@pytest.mark.parametrize("mode", ["full", "sorted"])
@pytest.mark.parametrize("name", ["cornell", "kinds_envmap"])
def test_card_step_equals_per_chunk_round_and_plain(name, mode, on_card, monkeypatch):
    scene, n, pad, rec, target, p = _case(name)
    chunk = pad // 2
    # the step-level path, its chunks, spans, backward passes and counter
    opened, spans, grads_in_chunk = [], {}, []
    real_grad = torch.autograd.grad

    @contextlib.contextmanager
    def tracked(name_):
        opened.append(name_)
        spans[name_] = spans.get(name_, 0) + 1
        try:
            yield
        finally:
            opened.pop()

    def grad(*a, **k):
        grads_in_chunk.append("m3t.replay.chunk" in opened)
        return real_grad(*a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(replay, "span", tracked)
        mp.setattr(torch.autograd, "grad", grad)
        mp.setattr(prof_mod, "_profiling", lambda: True)
        prof_mod.drain()
        got = replay_grads(scene, p, update, target, SEED, rec, n, chunk=chunk, mode=mode, **KW)
        counts = prof_mod.drain()
    passes = 2 if mode == "sorted" else 1          # the sorted mode's film pass
    assert on_card == {"fwd": 2 * passes, "adj": 2, "pack": 1}
    assert spans["m3t.replay.chunk"] == 2 * passes
    assert grads_in_chunk == [False]
    assert counts["m3t.replay.step_rows"] == pad * passes

    ref = _per_chunk(mode, scene, p, rec, target, n, chunk)
    _close(got, ref, 1e-5, 1e-6, f"{name} {mode} per-chunk")
    with monkeypatch.context() as mp:
        mp.setattr(replay, "_on_card", lambda device: False)
        calls = replay.plain_calls
        plain = replay_grads(scene, p, update, target, SEED, rec, n, chunk=chunk, mode=mode,
                             **KW)
        assert replay.plain_calls > calls
    _close(got, plain, 1e-3, 1e-4, f"{name} {mode} plain")


@pytest.mark.parametrize("mode", ["full", "sorted"])
@pytest.mark.parametrize("name", ["cornell", "kinds_envmap"])
def test_card_step_masks_non_finite_radiance(name, mode, on_card, monkeypatch):
    """With K5's forward giving inf and nan on some rows' channels, the
    step-level loop gives the per-chunk autograd round's gradients, whose
    splat puts 0 there and so passes no derivative to those channels."""
    scene, n, pad, rec, target, p = _case(name)

    def poisoned(packed):
        L = host.forward_packed(packed)
        L[::37, 0] = float("inf")
        L[::41, 2] = float("nan")
        return L

    monkeypatch.setattr(replay_cuda, "replay_forward", poisoned)
    got = replay_grads(scene, p, update, target, SEED, rec, n, chunk=pad // 2, mode=mode, **KW)
    ref = _per_chunk(mode, scene, p, rec, target, n, pad // 2)
    _close(got, ref, 1e-5, 1e-6, f"{name} {mode} non-finite")


@pytest.mark.parametrize("key", ["materials.params", "textures.data", "camera.to_world"])
def test_card_step_raises_for_keys_k5_does_not_differentiate(key, on_card):
    scene, n, pad, rec, target, _ = _case("kinds_envmap")
    x = {key: params.traverse(scene)[key].detach().clone()}
    for mode in ("full", "sorted"):
        with pytest.raises(ValueError, match=key):
            replay_grads(scene, x, params.update, target, SEED, rec, n, chunk=pad // 2,
                         mode=mode, **KW)
    assert on_card == {"fwd": 0, "adj": 0, "pack": 0}


def _samples(n=3000, w=16, h=12):
    """Film positions (some of them farther off the film than any filter
    reaches), radiance with non-finite channels, the active rows, a random
    target."""
    g = torch.Generator().manual_seed(1)
    pos = torch.rand((n, 2), generator=g) * torch.tensor([w + 6.0, h + 6.0]) - 3.0
    L = torch.rand((n, 3), generator=g) * 2.0
    L[::97, 1] = float("inf")
    L[::89, 0] = float("nan")
    L[::83, 2] = -float("inf")
    active = torch.rand((n,), generator=g) < 0.9
    target = torch.rand((h, w, 3), generator=g) * 0.5
    return pos, L, active, target


def _splat_of(x, pos, active, rfilter, w=16, h=12):
    return filmlib.put(filmlib.new_film(w, h, device="cpu"), pos,
                       torch.where(torch.isfinite(x), x, 0.0), active=active, rfilter=rfilter)


@pytest.mark.parametrize("rfilter", ["box", "tent", "gaussian"])
def test_put_adjoint_is_autograds_transpose_of_put(rfilter):
    pos, L, active, _ = _samples()
    adj = torch.randn((12, 16, 3), generator=torch.Generator().manual_seed(2))
    x = L.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad((adj * _splat_of(x, pos, active, rfilter)[..., :3]).sum(), [x])
    t = filmlib.taps(pos, active, rfilter, 12, 16)
    got = replay._splat_adjoint(adj, torch.isfinite(L), t)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    # no tap of the gaussian's (radius 2) reaches the film from here
    off = (pos < -1.5).any(dim=1) | (pos[:, 0] >= 17.5) | (pos[:, 1] >= 13.5)
    assert int(off.sum()) > 100 and int((~active).sum()) > 100
    assert bool((got[~active] == 0).all()) and bool((got[off] == 0).all())
    assert bool((got[~torch.isfinite(L)] == 0).all())
    assert float(got[active & ~off].abs().min(dim=1).values.max()) > 0
    # on finite radiance the gather alone is the transpose
    y = torch.zeros_like(L).requires_grad_(True)
    f = filmlib.put(filmlib.new_film(16, 12, device="cpu"), pos, y, active=active, rfilter=rfilter)
    (ref,) = torch.autograd.grad((adj * f[..., :3]).sum(), [y])
    torch.testing.assert_close(filmlib.put_adjoint(adj, pos, active, rfilter), ref,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rfilter", ["box", "tent", "gaussian"])
def test_chunk_adjoint_is_autograds_through_develop_and_the_mask(rfilter):
    pos, L, active, target = _samples(n=40)         # a chunk that leaves pixels uncovered
    x = L.clone().requires_grad_(True)
    f = _splat_of(x, pos, active, rfilter)
    msk = (f[..., 3] > 0.0)[..., None]
    loss = torch.where(msk, (filmlib.develop(f) - target) ** 2, 0.0).sum()
    (ref,) = torch.autograd.grad(loss, [x])
    ok, t = torch.isfinite(L), filmlib.taps(pos, active, rfilter, 12, 16)
    film = replay._put(filmlib.new_film(16, 12, device="cpu"), L, ok, t)
    torch.testing.assert_close(film, _splat_of(L, pos, active, rfilter), rtol=0, atol=0)
    got = replay._splat_adjoint(replay._film_adjoint(film, target), ok, t)
    assert float(ref.abs().max()) > 0 and not bool(msk.all())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * float(ref.abs().max()))
