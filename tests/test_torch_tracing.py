"""The port's spans (`jpgenc_tpu_torch.utils.profiling.span`): profiler
ranges entered only while a profiler runs, one `jpgenc.retry` for each image
that overflowed the tight tier, one `jpgenc.fetch_wait` a fetch and one
`jpgenc.refetch_wait` a refetch, and with optimize one `jpgenc.pass1`,
`jpgenc.hist_wait` and `jpgenc.tables` an entry a call, one
`jpgenc.finalize_host` a finalize, every range on the calling thread; they
change no byte. `engine.fetched_bytes` loses nothing under threads.

The test marked `gpu` needs CUDA (`stage_batch` pins only for a card); it
imports no JAX, so it runs on the card's machine without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""
import sys
import threading

import numpy as np
import pytest
import torch
import torch._C._profiler
from torch.profiler import ProfilerActivity, profile

from jpgenc_tpu_torch import api, engine, native
from jpgenc_tpu_torch.config import EncodeConfig
from jpgenc_tpu_torch.parallel import mesh
from jpgenc_tpu_torch.utils import profiling
from jpgenc_tpu_torch.utils.fixtures import synth_frame

H, W = 48, 64


def _frames(seed: int = 200) -> np.ndarray:
    """Smooth frames and noise frames, alternating: the noise (each sample
    0 or 255) overflows the tight tier at Q75 and at Q90, the smooth frames
    do not."""
    noise = np.random.default_rng(seed).integers(0, 2, size=(2, H, W, 3),
                                                 dtype=np.uint8) * 255
    return np.stack([synth_frame(H, W, seed=seed + 1), noise[0],
                     synth_frame(H, W, seed=seed + 2), noise[1]])


def _ranges(prof, prefix: str = "jpgenc.") -> list:
    """(name, start, end) of the profile's ranges named with the prefix."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefix)), key=lambda r: r[1])


def _names(prof) -> list:
    return [r[0] for r in _ranges(prof)]


def _tight_overflows(imgs: np.ndarray, quality: int = 75,
                     subsampling: str = "420") -> int:
    """The images of one tight-tier call that come back None."""
    plan = engine.get_plan(imgs.shape[1], imgs.shape[2], subsampling,
                           quality, "cpu")
    job = engine.EncodeJob(plan, EncodeConfig(quality=quality,
                                              subsampling=subsampling),
                           torch.from_numpy(imgs))
    job.first_pass()
    job.second_pass()
    return sum(s is None for s in job.finish())


def test_no_profiler_enters_no_range(monkeypatch):
    """With no profiler running a span is the shared no-op: the range type
    is never built, and the files are those of an unpatched call."""
    imgs = _frames()
    want = mesh.encode_batch(imgs, device="cpu")

    def refuse(name):
        raise AssertionError(f"range {name} entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert profiling.span("jpgenc.x") is profiling.span("jpgenc.y")
    assert mesh.encode_batch(imgs, device="cpu") == want


def test_traced_retries_nest_their_fetch_and_finalize():
    """Under a profiler: one `jpgenc.retry` range an overflowed image, each
    holding its `jpgenc.fetch_wait` and `jpgenc.finalize_host`; one
    `jpgenc.fetch_wait` and one `jpgenc.finalize_host` a fetch; the same
    files as untraced. The ranges are host operations, not user
    annotations."""
    imgs = _frames(210)
    want = mesh.encode_batch(imgs, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = mesh.encode_batch(imgs, device="cpu")
    assert got == want
    ranges = _ranges(prof)
    names = [r[0] for r in ranges]
    retries = [r for r in ranges if r[0] == "jpgenc.retry"]
    assert len(retries) == _tight_overflows(imgs) == 2
    for _, s, e in retries:
        inside = {n for n, a, b in ranges if s < a and b <= e}
        assert {"jpgenc.fetch_wait", "jpgenc.finalize_host"} <= inside
    assert names.count("jpgenc.fetch_wait") == 3
    assert names.count("jpgenc.finalize_host") == 3
    assert names.count("jpgenc.refetch_wait") <= 3
    flags = {e.is_user_annotation() for e in
             prof.profiler.kineto_results.events()
             if e.name().startswith("jpgenc.")}
    assert flags == {False}


@pytest.mark.parametrize("quality,subsampling,devices", [
    (75, "420", None), (90, "420", None), (75, "444", None),
    (75, "420", ["cpu", "cpu"])])
def test_retry_spans_are_the_tight_tiers_overflows(quality, subsampling,
                                                   devices):
    """`overflow_pct` counts `jpgenc.retry` ranges over images: encode_batch
    retries exactly the images that one tight-tier call returns as None,
    one range each, whatever the quality, sampling or entries."""
    imgs = np.concatenate([_frames(220), _frames(221)])
    want = _tight_overflows(imgs, quality, subsampling)
    assert want > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mesh.encode_batch(imgs, quality=quality, subsampling=subsampling,
                          device="cpu", devices=devices)
    assert _names(prof).count("jpgenc.retry") == want


@pytest.mark.parametrize("guess,refetches", [(1, 1), (1 << 20, 0)])
def test_a_short_guess_counts_one_refetch(guess, refetches):
    """A prefix guess below the need refetches once, one
    `jpgenc.refetch_wait` range; a guess above it never does. The bytes
    fetched are those of the copies made, as before."""
    imgs = torch.from_numpy(np.stack([synth_frame(32, 48, seed=s)
                                      for s in (9, 10)]))
    plan = engine.get_plan(32, 48, "420", 75, "cpu")
    cap = engine.scan_caps(plan.layout, 75, "worst")[0]
    outs = plan(imgs, cap, 56)
    wstream, nbits, _ = outs
    with plan._guess_lock:
        plan.prefix_guess = guess
    engine.fetched_bytes = 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = plan.fetch(outs, cap)
    names = _names(prof)
    assert names.count("jpgenc.fetch_wait") == 1
    assert names.count("jpgenc.refetch_wait") == refetches
    t = max(len(u) for u, _, _ in res)
    assert t > 1
    k = min(guess, wstream.shape[1])
    assert engine.fetched_bytes == 4 * 2 * (k + nbits.shape[-1] + 1) + \
        refetches * 4 * 2 * t


def test_counters_lose_nothing_under_threads():
    """Eight threads fetching at once: every increment of
    `engine.fetched_bytes` lands."""
    n_threads, n_iter = 8, 2000
    t = torch.zeros(3, dtype=torch.int32)
    start = threading.Barrier(n_threads)
    errors = []

    def worker():
        try:
            start.wait(timeout=30)
            for _ in range(n_iter):
                engine.to_host_async(t)
        except Exception as exc:      # noqa: BLE001  (reported below)
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        engine.fetched_bytes = 0
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads) and not errors
    finally:
        sys.setswitchinterval(old)
    assert engine.fetched_bytes == n_threads * n_iter * 12


def test_api_encode_counts_its_tiers():
    """api.encode's tier loop fetches once a tier it climbs: noise at Q75
    overflows the tight tier, so a traced call holds one
    `jpgenc.fetch_wait` more than the tiers it overflowed, and its file is
    the untraced one."""
    noise = _frames(230)[1]
    want = api.encode(noise, quality=75, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = api.encode(noise, quality=75, device="cpu")
    assert got == want
    fetches = _names(prof).count("jpgenc.fetch_wait")
    assert _tight_overflows(noise[None]) == 1 and fetches >= 2


PASS_SPANS = ("jpgenc.pass1", "jpgenc.hist_wait", "jpgenc.tables")


def _encode(entry: str, imgs: np.ndarray, optimize: bool) -> list:
    if entry == "api":
        return [api.encode(f, optimize=optimize, device="cpu") for f in imgs]
    devices = ["cpu", "cpu"] if entry == "two_entries" else None
    return mesh.encode_batch(imgs, optimize=optimize, device="cpu",
                             devices=devices)


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("entry,per_call", [("one_entry", 1),
                                            ("two_entries", 2), ("api", 1)])
def test_two_pass_spans(entry, per_call, optimize):
    """The two-pass mode's host stages: one `jpgenc.pass1`,
    `jpgenc.hist_wait` and `jpgenc.tables` an entry a call with optimize,
    none without; the table build holds no retry; the same files as
    untraced."""
    imgs = _frames(250)
    want = _encode(entry, imgs, optimize)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _encode(entry, imgs, optimize)
    assert got == want
    ranges = _ranges(prof)
    names = [r[0] for r in ranges]
    calls = len(imgs) if entry == "api" else 1
    for name in PASS_SPANS:
        assert names.count(name) == (calls * per_call if optimize else 0)
    retries = [(s, e) for n, s, e in ranges if n == "jpgenc.retry"]
    assert bool(retries) == (entry != "api")
    for _, s, e in (r for r in ranges if r[0] == "jpgenc.tables"):
        assert not any(s <= a < e for a, _ in retries)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: stage_batch pins only for CUDA")
    return "cuda"


@pytest.mark.gpu
def test_stage_pin_span_on_the_card(cuda):
    """stage_batch's pinned copy is one `jpgenc.stage.pin` range a call on
    the card, and the staged encode equals the unstaged one."""
    imgs = _frames(240)
    want = mesh.encode_batch(imgs, device=cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        staged = mesh.stage_batch(imgs, device=cuda)
        got = mesh.encode_batch(None, staged=staged, device=cuda)
    assert got == want
    names = [r[0] for r in _ranges(prof)]
    assert names.count("jpgenc.stage.pin") == 1
    card = [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("jpgenc.")
            and "cuda" in str(e.device_type()).lower()]
    assert card == []


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_one_finalize_span_a_finish_on_the_calling_thread(devices,
                                                         monkeypatch):
    """Each finish and each retry's re-code finalizes its rows in one
    native call: exactly one `jpgenc.finalize_host` range each, even with
    the rows spread over three C++ workers, and every `jpgenc.*` range on
    the thread that called encode_batch (the workers open none). The files
    are the untraced ones."""
    imgs = _frames(260)
    want = mesh.encode_batch(imgs, device="cpu", devices=devices)
    overflows = _tight_overflows(imgs)
    real = native.finalize_rows
    monkeypatch.setattr(native, "finalize_rows",
                        lambda *a, **kw: real(*a, **kw, n_threads=3))
    finalized = []
    for name in ("finish", "recode"):
        def counted(self, *args, _real=getattr(engine.EncodeJob, name),
                    _name=name):
            finalized.append(_name)
            return _real(self, *args)
        monkeypatch.setattr(engine.EncodeJob, name, counted)
    workers = native.finalize_workers
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            got = mesh.encode_batch(imgs, device="cpu", devices=devices)
    assert got == want
    assert finalized.count("finish") == len(devices or [None])
    assert finalized.count("recode") == overflows == 2
    assert _names(prof).count("jpgenc.finalize_host") == len(finalized)
    assert native.finalize_workers - workers > len(finalized)
    events = prof.profiler.kineto_results.events()
    caller = {e.start_thread_id() for e in events if e.name() == "caller"}
    threads = {e.start_thread_id() for e in events
               if e.name().startswith("jpgenc.")}
    assert len(caller) == 1 and threads == caller
